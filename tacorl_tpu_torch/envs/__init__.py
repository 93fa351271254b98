from tacorl_tpu_torch.envs.fake_calvin import FakeCalvinEnv  # noqa: F401
