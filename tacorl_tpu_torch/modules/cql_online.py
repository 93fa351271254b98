"""Online CQL (port of tacorl_tpu/modules/cql_online.py; reference:
modules/cql/cql_online_lightning.py:16-310): SAC's env-in-the-loop training
with the conservative penalty (``configs/module/cql_online.yaml`` sets the
Lagrange alpha')."""

from __future__ import annotations

from tacorl_tpu_torch.modules.sac import SACModule

__all__ = ["CQLOnlineModule"]


class CQLOnlineModule(SACModule):
    name = "cql_online"
    use_conservative = True
