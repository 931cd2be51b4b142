"""One diagnostic grammar for every tunable-knob parse error (the JAX
package's ``utils/knobs.py``).

The profile-relevant knobs (``FGUMI_TPU_MESH``, ``FGUMI_TPU_SHAPE_BUCKETS``,
the deployment profile's fields) are parsed in several modules; every knob
parse error goes through :func:`knob_error`, so the same class of mistake
reads the same wherever it is caught:

    KNOB=<offending token>: <what is wrong>; expected <accepted grammar>

All of them surface as exit 2 (the CLI maps ``MeshConfigError`` and the
profile loader's ``ProfileError`` there).
"""


def knob_error(knob: str, token, problem: str, grammar: str) -> str:
    """The knob diagnostic. ``token`` is the offending value exactly as the
    user supplied it (repr'd so whitespace and empty strings survive);
    ``grammar`` states what would have been accepted."""
    return f"{knob}={token!r}: {problem}; expected {grammar}"
