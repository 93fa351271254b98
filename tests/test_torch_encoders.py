"""The port's off-path encoders held against the JAX package on the CPU:
``CustomEncoder`` (plain, max-pooled with an output LayerNorm, and with
the VIB head under JAX's normals), ``ResNetRLEncoder``,
``DeepSpatialEncoder`` and ``ResNet18Encoder`` (BatchNorm in train mode,
running statistics after one step, eval mode), ``R3MEncoder`` (frozen
backbone) and ``VectorEncoder``; the converter's posterior LayerNorm
options; every name in the ``__all__`` of ``tacorl_tpu/networks/*.py``
through the port's ``get_class``; and the BatchNorm-in-a-module fault in
both packages. Weights are flax's, randomized and carried across by
tacorl_tpu_torch/utils/convert.py; images are float32 (``compute_dtype``
None), NHWC on the JAX side and NCHW on the port's.

Tolerances: forwards atol 1e-5, gradients rtol 1e-4 (atol 1e-5),
BatchNorm running statistics atol 1e-6. ResNet-18 runs at
``stage_sizes=(1, 1)``, width 8 on 32x32 images; R3M's fixed backbone
(full ResNet-18, bfloat16 convolutions in both packages) runs eagerly,
unjitted, on 32x32, held at the bf16 tolerance 2e-2."""

import importlib
import pkgutil

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tacorl_tpu.networks as j_networks
from tacorl_tpu.modules.play_lmp import PlayLMPModule as JaxPlayLMPModule
from tacorl_tpu.networks import encoders as j_enc
from tacorl_tpu.networks import plan_recognition as j_pr
from tacorl_tpu.networks import resnet as j_resnet
from tacorl_tpu_torch.config import get_class
from tacorl_tpu_torch.modules.play_lmp import PlayLMPModule
from tacorl_tpu_torch.networks import encoders as t_enc
from tacorl_tpu_torch.networks import plan_recognition as t_pr
from tacorl_tpu_torch.networks import resnet as t_resnet
from tacorl_tpu_torch.networks.late_fusion import BATCHNORM_FAULT, build_late_fusion
from tacorl_tpu_torch.utils import convert

ATOL = 1e-5
N = 2


def _randomized(params, seed=0, scale=0.3):
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda x: (rs.randn(*np.shape(x)) * scale).astype(np.float32), params)


def _init(jmod, x, seed, scale=0.3):
    """Randomized params and flax's initial batch statistics (mean 0, var
    1), from the init's shapes alone (no init is run)."""
    shapes = jax.eval_shape(jmod.init, jax.random.key(0), jnp.asarray(x))
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: np.full(v.shape, 1.0 if jax.tree_util.keystr(path).endswith("'var']") else 0.0, np.float32),
        shapes.get("batch_stats", {}),
    )
    return _randomized(shapes["params"], seed, scale), stats


def _close(got, want, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), atol=atol, rtol=rtol)


def _images(hw, seed=0, c=3):
    return np.random.RandomState(seed).rand(N, hw, hw, c).astype(np.float32) * 2 - 1


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _grads_match(jmod, variables, x, tmod, batch_stats=None):
    """d sum(out * w) / d params on both sides, through the converter."""
    w = None

    def loss(p):
        nonlocal w
        out = jmod.apply({**variables, "params": p}, jnp.asarray(x))
        w = np.random.RandomState(5).randn(*out.shape).astype(np.float32)
        return jnp.sum(out * w)

    jgrads = convert.encoder_state_dict(jax.tree.map(np.asarray, jax.grad(loss)(variables["params"])))
    tmod.zero_grad()
    (tmod(_nchw(x)) * torch.from_numpy(w)).sum().backward()
    checked = 0
    for name, p in tmod.named_parameters():
        if p.grad is None:
            continue
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(), rtol=1e-4, atol=1e-5, err_msg=name)
        checked += 1
    assert checked == len(jgrads)


# -- CustomEncoder ---------------------------------------------------------------

CUSTOM = dict(latent_dim=6, conv_channels=(4, 8), kernel_sizes=(3, 3), strides=(2, 1), paddings=(1, 0),
              hidden_dim=10, compute_dtype=None)


@pytest.mark.parametrize("extra", [{}, {"max_pool": True, "normalize_output": True, "activation_function": "SiLU"}],
                         ids=["plain", "maxpool_layernorm"])
def test_custom_encoder_matches_jax(extra):
    x = _images(32)
    kw = {**CUSTOM, **extra}
    jmod = j_enc.CustomEncoder(**kw)
    variables = {"params": _init(jmod, x, 1)[0]}
    tmod = t_enc.CustomEncoder(**kw, input_hw=(32, 32))
    tmod.load_state_dict(convert.encoder_state_dict(variables["params"]))
    _close(tmod.eval()(_nchw(x)), jmod.apply(variables, jnp.asarray(x)))
    _grads_match(jmod, variables, x, tmod)


def test_custom_encoder_vib_head_under_jax_normals():
    x = _images(32, 2)
    kw = {**CUSTOM, "vib": True}
    jmod = j_enc.CustomEncoder(**kw)
    k = jax.random.key(3)
    params = _randomized(jmod.init({"params": k, "sample": k}, jnp.asarray(x))["params"], 2)
    out, inter = jmod.apply({"params": params}, jnp.asarray(x), rngs={"sample": jax.random.key(4)},
                            capture_intermediates=True, mutable=["intermediates"])
    dense = inter["intermediates"]
    mean = jnp.clip(dense["TorchDense_0"]["__call__"][0], -9.0, 9.0)
    std = jnp.exp(jnp.clip(dense["TorchDense_1"]["__call__"][0], -5.0, 2.0))
    eps = torch.from_numpy(np.array((out - mean) / std))
    tmod = t_enc.CustomEncoder(**kw, input_hw=(32, 32))
    sd = convert.encoder_state_dict(params)
    assert {"fc_mean.weight", "fc_log_std.weight"} <= set(sd)
    tmod.load_state_dict(sd)
    _close(tmod(_nchw(x), eps=eps), out)


@pytest.mark.parametrize("vib", [False, True], ids=["fc1_fc2", "vib"])
def test_custom_encoder_converter_refuses_to_guess_its_head(vib):
    """8x8 images flatten to 32 features: a VIB latent 32 wide, or a hidden
    layer and a latent both 32 wide, make both readings of the two denses
    fit. The converter then raises unless told ``vib``, and maps the heads
    as told."""
    x = _images(8, 5)
    kw = {**CUSTOM, "vib": vib, "latent_dim": 32, **({} if vib else {"hidden_dim": 32})}
    jmod = j_enc.CustomEncoder(**kw)
    params = _init(jmod, x, 6)[0]
    with pytest.raises(ValueError, match="pass vib="):
        convert.encoder_state_dict(params)
    sd = convert.encoder_state_dict(params, vib=vib)
    tmod = t_enc.CustomEncoder(**kw, input_hw=(8, 8))
    tmod.load_state_dict(sd)
    heads = ("fc_mean", "fc_log_std") if vib else ("fc1", "fc2")
    for i, name in enumerate(heads):
        _close(sd[f"{name}.weight"], np.asarray(params[f"TorchDense_{i}"]["kernel"]).T)
    if not vib:
        _close(tmod.eval()(_nchw(x)), jmod.apply({"params": params}, jnp.asarray(x)))


def test_custom_encoder_converter_checks_the_vib_it_is_told():
    x = _images(32)
    params = _init(j_enc.CustomEncoder(**CUSTOM), x, 1)[0]
    with pytest.raises(ValueError, match="vib=True"):
        convert.encoder_state_dict(params, vib=True)


def test_custom_encoder_needs_the_image_size():
    with pytest.raises(ValueError, match="input_hw"):
        t_enc.CustomEncoder(**CUSTOM)


# -- ResNetRLEncoder ---------------------------------------------------------------


@pytest.mark.parametrize("normalize_output", [False, True])
def test_resnet_rl_encoder_matches_jax(normalize_output):
    x = _images(24, 3)
    kw = dict(latent_dim=6, hidden_channels=8, num_residual_blocks=2, residual_hidden_channels=4,
              normalize_output=normalize_output, compute_dtype=None)
    jmod = j_enc.ResNetRLEncoder(**kw)
    params = _init(jmod, x, 4)[0]
    params["SpatialSoftArgmax_0"]["temperature"] = np.asarray([0.8], np.float32)
    tmod = t_enc.ResNetRLEncoder(**kw)
    tmod.load_state_dict(convert.encoder_state_dict(params))
    _close(tmod(_nchw(x)), jmod.apply({"params": params}, jnp.asarray(x)))
    _grads_match(jmod, {"params": params}, x, tmod)


# -- BatchNorm encoders ------------------------------------------------------------------


def _bn_case(jmod, tmod, x, seed):
    """Train-mode forward (batch statistics) with the running statistics
    it leaves, then an eval-mode forward on those statistics."""
    params, stats0 = _init(jmod, x, seed)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        if "temperature" in jax.tree_util.keystr(path):
            leaf[...] = 0.9
    tmod.load_state_dict(convert.encoder_state_dict(params, stats0))
    jout, mutated = jmod.apply({"params": params, "batch_stats": stats0}, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    tout = tmod.train()(_nchw(x))
    _close(tout, jout)
    stats1 = jax.tree.map(np.asarray, mutated["batch_stats"])
    want = convert.encoder_state_dict(params, stats1)
    running = {k: v for k, v in tmod.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    assert running and set(running) <= set(want)
    for name, value in running.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-6, rtol=0, err_msg=name)
    x2 = _images(x.shape[1], seed + 1)
    jeval = jmod.apply({"params": params, "batch_stats": stats1}, jnp.asarray(x2))
    _close(tmod.eval()(_nchw(x2)), jeval)
    return tmod


def test_deep_spatial_encoder_batch_norm_matches_flax():
    x = _images(40, 6)
    tmod = _bn_case(j_enc.DeepSpatialEncoder(compute_dtype=None), t_enc.DeepSpatialEncoder(compute_dtype=None), x, 7)
    assert tmod.latent_dim == 32


def test_deep_spatial_encoder_without_batch_norm_matches_jax():
    x = _images(40, 8)
    jmod = j_enc.DeepSpatialEncoder(use_batch_norm=False, temperature=0.5, compute_dtype=None)
    # without BatchNorm three convs at the default scale saturate the
    # spatial softmax, which then magnifies float32 rounding
    params = _init(jmod, x, 9, scale=0.1)[0]
    tmod = t_enc.DeepSpatialEncoder(use_batch_norm=False, temperature=0.5, compute_dtype=None)
    tmod.load_state_dict(convert.encoder_state_dict(params))
    _close(tmod(_nchw(x)), jmod.apply({"params": params}, jnp.asarray(x)))


def test_resnet18_encoder_matches_flax_with_torchvision_keys():
    x = _images(32, 10)
    kw = dict(latent_dim=6, stage_sizes=(1, 1), width=8, compute_dtype=None)
    tmod = _bn_case(j_resnet.ResNet18Encoder(**kw), t_resnet.ResNet18Encoder(**kw), x, 11)
    keys = set(tmod.state_dict())
    assert {"conv1.weight", "bn1.running_mean", "layer1.0.conv1.weight", "layer2.0.downsample.0.weight",
            "layer2.0.downsample.1.running_var", "fc.weight"} <= keys
    assert not any(k.startswith("layer1.0.downsample") for k in keys)


def test_r3m_encoder_freezes_its_backbone():
    x = _images(32, 12)
    jmod = j_resnet.R3MEncoder(latent_dim=6, hidden_dim=10)
    params, stats = _init(jmod, x, 13, scale=0.1)
    stats = jax.tree.map(lambda v: np.abs(v) + 0.5, stats)
    tmod = t_resnet.R3MEncoder(latent_dim=6, hidden_dim=10)
    tmod.load_state_dict(convert.encoder_state_dict(params, stats))
    # R3M's backbone convolves in bfloat16 in both packages (it has no
    # float32 option): bf16 tolerance
    jout = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=True)
    tout = tmod.train()(_nchw(x))
    assert not tmod.backbone.training and all(not p.requires_grad for p in tmod.backbone.parameters())
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=2e-2, rtol=2e-2)
    before = {k: v.clone() for k, v in tmod.state_dict().items() if k.startswith("backbone.")}
    tout.sum().backward()
    assert tmod.head1.weight.grad is not None
    assert all(torch.equal(v, tmod.state_dict()[k]) for k, v in before.items())


@pytest.mark.parametrize("hidden", [(), (5,)])
def test_vector_encoder_matches_jax(hidden):
    x = np.random.RandomState(14).randn(N, 7).astype(np.float32)
    jmod = j_enc.VectorEncoder(latent_dim=4, hidden=hidden)
    params = _init(jmod, x, 15)[0] if hidden else {}
    tmod = t_enc.VectorEncoder(latent_dim=4, hidden=hidden, in_features=7)
    tmod.load_state_dict(convert.encoder_state_dict(params))
    _close(tmod(torch.from_numpy(x)), jmod.apply({"params": params}, jnp.asarray(x)))


# -- building from configs ---------------------------------------------------------------


def test_late_fusion_builds_r3m_and_refuses_a_trainable_resnet():
    """R3M's frozen backbone (eval-mode BatchNorm in train mode) is built;
    a ResNet-18 whose BatchNorm trains is refused."""
    r3m = {"_target_": "tacorl_tpu.networks.resnet.R3MEncoder", "latent_dim": 5, "hidden_dim": 8, "width": 8,
           "r3m_trunk": True, "compute_dtype": None}
    fusion = build_late_fusion({"rgb_static": r3m}, ["rgb_static"], {}, {"rgb_static": (32, 32)})
    assert fusion.encode({"rgb_static": torch.rand(N, 3, 32, 32)}, ["rgb_static"]).shape == (N, 5)
    resnet = {"_target_": "tacorl_tpu.networks.resnet.ResNet18Encoder", "latent_dim": 5, "stage_sizes": [1],
              "width": 8}
    with pytest.raises(NotImplementedError, match="ResNet18Encoder") as err:
        build_late_fusion({"rgb_static": resnet}, ["rgb_static"], {}, {"rgb_static": (32, 32)})
    assert BATCHNORM_FAULT in str(err.value)


def test_late_fusion_gives_each_encoder_its_input_shape():
    networks = {
        "rgb_static": {"_target_": "tacorl_tpu.networks.encoders.CustomEncoder", **CUSTOM},
        "depth_static": {"_target_": "tacorl_tpu.networks.encoders.ResNetRLEncoder", "latent_dim": 5,
                         "hidden_channels": 8, "residual_hidden_channels": 4, "compute_dtype": None},
    }
    fusion = build_late_fusion(networks, ["rgb_static", "depth_static", "robot_obs"], {"robot_obs": 3},
                               {"rgb_static": (40, 40), "depth_static": (24, 24)})
    assert fusion.networks["rgb_static"].fc1.in_features == 18 * 18 * 8  # 40x40 -> 20x20x4 -> 18x18x8
    obs = {"rgb_static": torch.randn(N, 3, 40, 40), "depth_static": torch.randn(N, 3, 24, 24),
           "robot_obs": torch.randn(N, 3)}
    assert fusion.calc_state_dim(["rgb_static", "depth_static", "robot_obs"]) == 14
    assert fusion.encode(obs, ["rgb_static", "depth_static", "robot_obs"]).shape == (N, 14)


@pytest.mark.parametrize("target", ["encoders.DeepSpatialEncoder", "resnet.ResNet18Encoder", "resnet.R3MEncoder"])
def test_batch_norm_encoders_fail_in_both_modules(target):
    """The JAX module keeps only "params", so a BatchNorm encoder's train
    step fails for want of "batch_stats"; the port refuses to build one
    whose BatchNorm trains and builds R3M's, whose frozen backbone keeps
    its statistics as buffers no step changes."""
    from tests.test_torch_play_lmp import _batch, _cfg

    extra = {"stage_sizes": [1], "width": 8} if target.endswith("ResNet18Encoder") else {}
    cfg = _cfg()
    cfg["perceptual_encoder"]["networks"]["rgb_static"] = {"_target_": f"tacorl_tpu.networks.{target}",
                                                           "latent_dim": 16, **extra}
    if target.endswith("DeepSpatialEncoder"):
        cfg["perceptual_encoder"]["networks"]["rgb_static"].pop("latent_dim")
    jmod = JaxPlayLMPModule(cfg)
    states = jmod.transforms(jax.random.key(2), _batch()["states"], train=False)
    # the module's init keeps "params" alone (JaxPlayLMPModule.init_state)
    params = jax.jit(lambda s: jmod.net.init(jax.random.key(0), s, True, method="get_emb_states"))(states)
    assert set(params) == {"params", "batch_stats"}
    # the train step's loss opens with these embeddings
    with pytest.raises(flax.errors.ScopeCollectionNotFound, match="batch_stats"):
        jmod.net.apply({"params": params["params"]}, states, True, method="get_emb_states")
    if target.endswith("R3MEncoder"):
        module = PlayLMPModule(cfg, device="cpu")
        assert not module.net.perceptual_encoder.networks["rgb_static"].train().backbone.training
        return
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 3") as err:
        PlayLMPModule(cfg, device="cpu")
    assert BATCHNORM_FAULT in str(err.value)
    assert "R3MEncoder" not in BATCHNORM_FAULT


# -- the converter's posterior LayerNorms ------------------------------------------------


@pytest.mark.parametrize("positional,encoder", [(True, False), (False, True), (True, True)])
def test_posterior_layer_norm_options_convert(positional, encoder):
    rs = np.random.RandomState(16)
    x = rs.randn(N, 5, 12).astype(np.float32)
    kw = dict(state_dim=12, latent_plan_dim=4, num_heads=4, num_layers=1, encoder_hidden_size=16,
              fc_hidden_size=16, max_position_embeddings=8, dropout_p=0.0,
              positional_normalize=positional, encoder_normalize=encoder)
    jmod = j_pr.PlanRecognitionTransformer(**kw)
    params = _init(jmod, x, 17)[0]
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = t_pr.PlanRecognitionTransformer(**kw)
    if positional != encoder:
        with pytest.raises(ValueError, match="positional_normalize"):
            convert.plan_recognition_state_dict(params)
    tmod.load_state_dict(convert.plan_recognition_state_dict(params, positional_normalize=positional))
    got = tmod.eval()(torch.from_numpy(x))
    _close(got.mean, want.mean)
    _close(got.std, want.std)


# -- every JAX network name resolves in the port -----------------------------------------


@pytest.mark.parametrize("module", [m.name for m in pkgutil.iter_modules(j_networks.__path__)])
def test_every_network_name_resolves_in_the_port(module):
    names = importlib.import_module(f"tacorl_tpu.networks.{module}").__all__
    assert names
    for name in names:
        cls = get_class(f"tacorl_tpu.networks.{module}.{name}")
        assert cls.__module__ == f"tacorl_tpu_torch.networks.{module}", name
