"""Model registry of the port: every family of the JAX package but
Shift-GCN++ and its teacher, for which asking raises
``NotImplementedError``."""

from stgx_torch.models.aagcn import AaGcn
from stgx_torch.models.costgcn import CoStgcn
from stgx_torch.models.msgcn import MsGcn
from stgx_torch.models.mstcn import MsTcn
from stgx_torch.models.rtstgcn import RtStgcn
from stgx_torch.models.shiftgcn import ShiftGcn
from stgx_torch.models.stgcn import Stgcn

# families of stgx.models that a later slice ports (ROADMAP.md, queue 1)
_NOT_PORTED = ("shift-gcn++", "shift-gcn++-teacher")


class _Registry(dict):
    def __missing__(self, name):
        if name in _NOT_PORTED:
            raise NotImplementedError(
                f"model {name!r} is not ported to stgx_torch yet; see the "
                "module queue in ROADMAP.md"
            )
        raise KeyError(f"unknown model: {name!r} (have {sorted(self)})")


MODELS = _Registry({
    "st-gcn": Stgcn,
    "co-st-gcn": CoStgcn,
    "rt-st-gcn": RtStgcn,
    "ms-tcn": MsTcn,
    "ms-gcn": MsGcn,
    "aa-gcn": AaGcn,
    "shift-gcn": ShiftGcn,
})

__all__ = ["MODELS", "Stgcn", "RtStgcn", "CoStgcn", "AaGcn", "MsTcn", "MsGcn", "ShiftGcn"]
