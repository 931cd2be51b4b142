"""The device mesh's specification grammar (the JAX package's
``parallel/mesh.py`` ``parse_mesh_spec``); the mesh itself is not yet
ported (multi-GPU)."""

import re

from . import MeshConfigError
from ..utils.knobs import knob_error

_MESH_RE = re.compile(r"^dp(\d+)(?:xsp(\d+))?$")
#: what ``FGUMI_TPU_MESH`` / ``--mesh`` accept
MESH_GRAMMAR = ("'auto', 'off', or 'dpNxspM' (e.g. dp4xsp2) with dp, "
                "sp >= 1")


def parse_mesh_spec(spec):
    """``FGUMI_TPU_MESH`` / ``--mesh`` value -> ``None`` (off), ``"auto"``,
    or ``(dp, sp)``: empty, ``off``, ``none``, ``0`` or ``1`` (no mesh),
    ``auto`` (every visible device along dp), or ``dpNxspM`` / ``dpN`` (sp
    defaults to 1). Anything else raises :class:`MeshConfigError` with the
    knob diagnostic."""
    if spec is None:
        return None
    s = str(spec).strip().lower()
    if s in ("", "off", "none", "0", "1"):
        return None
    if s == "auto":
        return "auto"
    m = _MESH_RE.match(s)
    if not m:
        raise MeshConfigError(knob_error(
            "FGUMI_TPU_MESH", spec, f"unrecognized shape {s!r}",
            MESH_GRAMMAR))
    dp = int(m.group(1))
    sp = int(m.group(2)) if m.group(2) else 1
    if dp < 1 or sp < 1:
        raise MeshConfigError(knob_error(
            "FGUMI_TPU_MESH", spec, f"dp={dp} sp={sp} below the >= 1 floor",
            MESH_GRAMMAR))
    return dp, sp
