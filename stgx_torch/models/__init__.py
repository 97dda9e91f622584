"""Model registry of the port: RT-ST-GCN, CoST-GCN and Shift-GCN so far;
asking for any other family of the JAX package raises
``NotImplementedError``."""

from stgx_torch.models.costgcn import CoStgcn
from stgx_torch.models.rtstgcn import RtStgcn
from stgx_torch.models.shiftgcn import ShiftGcn

# families of stgx.models that later slices port, in ROADMAP.md's order
_NOT_PORTED = (
    "st-gcn", "aa-gcn", "ms-tcn", "ms-gcn", "shift-gcn++",
    "shift-gcn++-teacher",
)


class _Registry(dict):
    def __missing__(self, name):
        if name in _NOT_PORTED:
            raise NotImplementedError(
                f"model {name!r} is not ported to stgx_torch yet; see the "
                "module queue in ROADMAP.md"
            )
        raise KeyError(f"unknown model: {name!r} (have {sorted(self)})")


MODELS = _Registry({"rt-st-gcn": RtStgcn, "co-st-gcn": CoStgcn, "shift-gcn": ShiftGcn})

__all__ = ["MODELS", "RtStgcn", "CoStgcn", "ShiftGcn"]
