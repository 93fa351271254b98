"""Trainer callbacks (port of tacorl_tpu/callbacks). Exported: what is
ported. ``TSNEPlot`` waits for ROADMAP Queue 1, item 17: a config that
names it fails in ``config.get_class`` with an error that names ROADMAP."""

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
