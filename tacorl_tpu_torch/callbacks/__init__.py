"""Trainer callbacks (port of tacorl_tpu/callbacks): every callback of the
JAX package, the t-SNE plan plot included (``tsne_plot.py``: exact t-SNE
in torch and a numpy rasteriser in place of scikit-learn and matplotlib)."""

from tacorl_tpu_torch.callbacks.base import Callback  # noqa: F401
from tacorl_tpu_torch.callbacks.horizon import (  # noqa: F401
    IncreaseHorizonConstant,
    IncreaseHorizonLinear,
)
from tacorl_tpu_torch.callbacks.horizon_uncertainty import (  # noqa: F401
    IncreaseHorizonUncertainty,
)
from tacorl_tpu_torch.callbacks.kl_schedule import (  # noqa: F401
    KLConstantSchedule,
    KLLinearSchedule,
    KLSigmoidSchedule,
)
from tacorl_tpu_torch.callbacks.rollout import (  # noqa: F401
    RolloutCallback,
    RolloutD4RLCallback,
    RolloutLongHorizonCallback,
)
from tacorl_tpu_torch.callbacks.tsne_plot import TSNEPlotCallback  # noqa: F401
