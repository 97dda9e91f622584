"""Strategy plug-ins and support utilities — the port of ``stgx/utils``.

Per-model registries of the Loss and Statistics flavors, keyed like the
JAX package's; the models not ported yet keep their keys so that the two
registries agree.
"""

from stgx_torch.utils.loss import Loss, LossMultiStage
from stgx_torch.utils.statistics import Statistics, StatisticsMultiStage

LOSS = {
    "st-gcn": Loss,
    "co-st-gcn": Loss,
    "rt-st-gcn": Loss,
    "ms-tcn": LossMultiStage,
    "ms-gcn": LossMultiStage,
    "aa-gcn": Loss,
    "shift-gcn": Loss,
    "shift-gcn++": Loss,
    "shift-gcn++-teacher": Loss,
}

STATISTICS = {
    "st-gcn": Statistics,
    "co-st-gcn": Statistics,
    "rt-st-gcn": Statistics,
    "ms-tcn": StatisticsMultiStage,
    "ms-gcn": StatisticsMultiStage,
    "aa-gcn": Statistics,
    "shift-gcn": Statistics,
    "shift-gcn++": Statistics,
    "shift-gcn++-teacher": Statistics,
}

__all__ = ["LOSS", "STATISTICS", "Loss", "LossMultiStage", "Statistics",
           "StatisticsMultiStage"]
