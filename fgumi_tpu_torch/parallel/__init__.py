"""Multi-GPU execution (the JAX package's ``parallel/``).

Only the mesh specification's grammar is here so far
(:func:`.mesh.parse_mesh_spec`): the CLI's refusal of ``--mesh`` and
``FGUMI_TPU_MESH`` and the deployment profile's validator read it. A mesh
itself is not yet ported (multi-GPU): a spec that asks for one exits 2.
"""


class MeshConfigError(ValueError):
    """A mesh specification that cannot be satisfied (a malformed spec).
    The CLI maps it to exit 2 with the message as its one line."""
