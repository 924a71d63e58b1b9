"""Parity of the port's full video VAE (ltx2_tpu_torch/models/video_vae/
resnet.py, full_vae.py), its strided convs, group norm and pixel shuffles
with the JAX package's, in float32 on the CPU at narrow widths (16-64
channels, 2-5 latent frames).

The same numpy trees (`random_tree` of the port's modules) and inputs go
through both packages; the conv runs through the port's plain version, the
kernel's contract (the kernels themselves are held against it on the card:
tests/test_torch_port_gpu.py, chip_smoke.py). The JAX package draws injected
noise from `jax.random` keys and the port from a `torch.Generator`; the
tests draw JAX's noise with JAX's own key splits and hand it to the port.
Limit: max|port - JAX| <= 1e-4 * max|JAX| (the two sum in different
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.models.video_vae import conv as jconv
from ltx2_tpu.models.video_vae import full_vae as jfull
from ltx2_tpu.models.video_vae import ops as jops
from ltx2_tpu.models.video_vae import resnet as jres
from ltx2_tpu.ops import common as jcommon
from ltx2_tpu_torch.loader.from_numpy import full_video_decoder_from_numpy, full_video_encoder_from_numpy
from ltx2_tpu_torch.loader.from_numpy import _load, flatten_tree
from ltx2_tpu_torch.models.video_vae import conv, full_vae, ops, resnet
from ltx2_tpu_torch.ops.common import group_norm
from tests.torch_port_util import assert_close, random_tree, t
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

RTOL = 1e-4  # max|port - JAX| <= RTOL * max|JAX|
CPU = torch.device("cpu")


def jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def x_of(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def jax_noise_pair(key, shape):
    """The two noises a JAX ResnetBlock3D draws from `key` (resnet.py:186-203)."""
    key, sub = jax.random.split(key)
    n1 = jax.random.normal(sub, shape, jnp.float32)
    _, sub = jax.random.split(key)
    return n1, jax.random.normal(sub, shape, jnp.float32)


def jax_mid_noise(key, num_layers, shape):
    """A JAX UNetMidBlock3D's per-block keys (resnet.py:253-262), drawn out."""
    pairs = []
    for _ in range(num_layers):
        key, sub = jax.random.split(key)
        pairs.append(jax_noise_pair(sub, shape))
    return pairs


def jax_init_shapes(init, cfg):
    """{dotted key: shape} of a JAX init's tree, traced without running it."""
    tree = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))
    return {k: str(v) for k, v in flatten_tree(jax.tree_util.tree_map(lambda s: str(tuple(s.shape)), tree)).items()}


def port_shapes(module):
    return {k: str(tuple(v.shape)) for k, v in module.state_dict().items()}


def torch_pairs(pairs):
    return [(t(a), t(b)) for a, b in pairs]


# ---------------------------------------------------------------- strided conv

STRIDES = [(1, 2, 2), (2, 1, 1), (2, 2, 2), (1, 1, 2)]
# (causal, spatial mode, temporal mode)
MODES = [(True, "zeros", "replicate"), (False, "reflect", "replicate"), (True, "reflect", "zeros"),
         (False, "zeros", "zeros")]


@pytest.mark.parametrize("stride", STRIDES, ids=lambda s: "s" + "".join(map(str, s)))
@pytest.mark.parametrize("mode", MODES, ids=lambda m: f"{'causal' if m[0] else 'sym'}_{m[1]}_{m[2]}")
def test_strided_conv_matches_jax(stride, mode):
    """conv3d_ndhwc at each stride and padding mode on odd T, H and W (the
    causal front pad of 2 frames meets sT = 2), Cout not a multiple of 8."""
    causal, sm, tm = mode
    x = x_of((2, 7, 9, 11, 16), 1)
    p = conv.Conv3d(16, 12)
    tree = random_tree(p, 2)
    _load(p, flatten_tree(tree))
    ref = jconv.conv3d_ndhwc(jtree(tree), jnp.asarray(x), causal=causal, spatial_mode=sm, temporal_mode=tm,
                             stride=stride)
    out = conv.conv3d_ndhwc(p, t(x), causal=causal, spatial_mode=sm, temporal_mode=tm, stride=stride)
    assert_close(out, ref, RTOL, f"stride {stride} {mode}")


def test_conv_boundaries():
    p = conv.Conv3d(16, 8)
    torch.nn.init.zeros_(p.weight)
    x = torch.zeros(1, 3, 5, 5, 16)
    assert conv.conv3d_ndhwc(p, x, stride=(2, 2, 2)).shape == (1, 2, 3, 3, 8)
    with pytest.raises(ValueError, match="stride"):
        conv.conv3d_ndhwc(p, x, stride=(1, 3, 1))
    with pytest.raises(NotImplementedError, match="scale-out"):
        conv.conv3d_ndhwc(p, x, w_halo_axis="w")


# ---------------------------------------------------------------- ops


@pytest.mark.parametrize("groups", [1, 4, 8])
def test_group_norm_matches_jax(groups):
    x = x_of((2, 16, 3, 4, 5), 3) * 2 + 0.5
    w, b = x_of((16,), 4), x_of((16,), 5)
    ref = jcommon.group_norm({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x), groups, 1e-6)
    assert_close(group_norm(t(x), groups, t(w), t(b), 1e-6), ref, RTOL, "channels first")
    norm = resnet.NormParams(16)
    _load(norm, {"weight": w, "bias": b})
    last = resnet.group_norm_ndhwc(t(x).permute(0, 2, 3, 4, 1).contiguous(), groups, norm, 1e-6)
    assert_close(last.permute(0, 4, 1, 2, 3), ref, RTOL, "channels last")
    assert_close(group_norm(t(x), groups), jcommon.group_norm(None, jnp.asarray(x), groups), RTOL, "no affine")


def test_pixel_shuffles_match_jax():
    x = x_of((2, 8, 3, 4, 6), 6)
    assert np.array_equal(ops.pixel_shuffle_3d(t(x), 2).numpy(), np.asarray(jops.pixel_shuffle_3d(jnp.asarray(x), 2)))
    assert np.array_equal(ops.pixel_unshuffle_3d(t(x), 2).numpy(),
                          np.asarray(jops.pixel_unshuffle_3d(jnp.asarray(x), 2)))
    assert torch.equal(ops.pixel_unshuffle_3d(ops.pixel_shuffle_3d(t(x), 2), 2), t(x))


# ---------------------------------------------------------------- blocks


@pytest.mark.parametrize("stride,skip", [((1, 1, 1), False), ((2, 2, 2), False), ((1, 2, 1), True)])
def test_dual_conv3d_matches_jax(stride, skip):
    p = resnet.DualConv3d(16, 24)
    tree = random_tree(p, 7)
    _load(p, flatten_tree(tree))
    x = x_of((2, 5, 7, 6, 16), 8)
    ref = jres.dual_conv3d(jtree(tree), jnp.asarray(x), stride, skip)
    assert_close(resnet.dual_conv3d(p, t(x), stride, skip), ref, RTOL, f"dual {stride}")


def test_conv_nd_refusal():
    p = resnet.DualConv3d(16, 16)
    x = torch.zeros(1, 2, 4, 4, 16)
    with pytest.raises(NotImplementedError, match="non-causal zero"):
        resnet.make_conv_nd_apply(p, x, (2, 1), causal=True)
    with pytest.raises(NotImplementedError, match="non-causal zero"):
        resnet.make_conv_nd_apply(p, x, (2, 1), causal=False, spatial_padding_mode=resnet.PaddingModeType.REFLECT)
    with pytest.raises(ValueError, match="unsupported dims"):
        resnet.make_conv_nd_apply(p, x, 2)


def _block_cfgs(norm, dims, in_c, out_c, tc, noise, pad):
    kw = dict(dims=dims, in_channels=in_c, out_channels=out_c, groups=8, inject_noise=noise, timestep_conditioning=tc)
    return (resnet.ResnetBlock3DConfig(norm_layer=resnet.NormLayerType(norm), spatial_padding_mode=
                                       resnet.PaddingModeType(pad), **kw),
            jres.ResnetBlock3DConfig(norm_layer=jres.NormLayerType(norm), spatial_padding_mode=
                                     jres.PaddingModeType(pad), **kw))


# (norm, dims, in, out, timestep conditioning, injected noise, spatial padding, causal)
BLOCKS = [
    ("pixel_norm", 3, 32, 32, False, False, "zeros", True),
    ("group_norm", 3, 32, 32, True, True, "reflect", False),
    ("pixel_norm", 3, 32, 32, True, True, "zeros", True),
    ("group_norm", 3, 32, 48, False, True, "zeros", True),  # the shortcut: norm3 + linear
    ("pixel_norm", (2, 1), 16, 32, False, False, "zeros", False),
    ("group_norm", (2, 1), 32, 32, True, True, "zeros", False),
]


@pytest.mark.parametrize("norm,dims,in_c,out_c,tc,noise,pad,causal", BLOCKS)
def test_resnet_block_matches_jax(norm, dims, in_c, out_c, tc, noise, pad, causal):
    cfg, jcfg = _block_cfgs(norm, dims, in_c, out_c, tc, noise, pad)
    p = resnet.ResnetBlock3D(cfg, device=CPU)
    tree = random_tree(p, 9)
    _load(p, flatten_tree(tree))
    x = x_of((2, 3, 5, 6, in_c), 10)
    timestep = x_of((2, 4 * in_c), 11) * 0.2 if tc else None
    key = jax.random.PRNGKey(12) if noise else None
    ref = jres.resnet_block_3d_apply(jtree(tree), jcfg, jnp.asarray(x), causal,
                                     None if timestep is None else jnp.asarray(timestep), key)
    pair = torch_pairs([jax_noise_pair(key, (2, 3, 5, 6, 1))])[0] if noise else None
    out = resnet.resnet_block_3d_apply(p, t(x), causal, None if timestep is None else t(timestep), noise=pair)
    assert_close(out, ref, RTOL, f"{norm} {dims} {in_c}->{out_c}")
    if noise:  # the injected noise moves the output
        plain = resnet.resnet_block_3d_apply(p, t(x), causal, None if timestep is None else t(timestep))
        assert not torch.allclose(plain, out)
    if tc:
        with pytest.raises(ValueError, match="timestep must be provided"):
            resnet.resnet_block_3d_apply(p, t(x), causal)


def test_resnet_block_draws_from_a_generator():
    cfg, _ = _block_cfgs("pixel_norm", 3, 16, 16, False, True, "zeros")
    p = resnet.ResnetBlock3D(cfg, device=CPU)
    _load(p, flatten_tree(random_tree(p, 13)))
    x = t(x_of((1, 2, 4, 4, 16), 14))
    a = resnet.resnet_block_3d_apply(p, x, generator=torch.Generator().manual_seed(1))
    b = resnet.resnet_block_3d_apply(p, x, generator=torch.Generator().manual_seed(1))
    c = resnet.resnet_block_3d_apply(p, x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="injected noise"):
        resnet.resnet_block_3d_apply(p, x, noise=(torch.zeros(1, 2, 4, 4, 2), torch.zeros(1, 2, 4, 4, 1)))
    with pytest.raises(ValueError, match="torch.Generator"):  # nothing is drawn from the global stream
        resnet.resnet_block_3d_apply(p, x, noise=(torch.zeros(1, 2, 4, 4, 1), None))


@pytest.mark.parametrize("dims,causal", [(3, True), ((2, 1), False)])
def test_mid_block_matches_jax(dims, causal):
    kw = dict(dims=dims, in_channels=32, num_layers=2, resnet_groups=8, inject_noise=True, timestep_conditioning=True)
    p = resnet.UNetMidBlock3D(resnet.UNetMidBlock3DConfig(**kw), device=CPU)
    tree = random_tree(p, 15)
    _load(p, flatten_tree(tree))
    x = x_of((1, 3, 4, 5, 32), 16)
    ts = x_of((1, 128), 17) * 0.2
    key = jax.random.PRNGKey(18)
    ref = jres.unet_mid_block_3d_apply(jtree(tree), jres.UNetMidBlock3DConfig(**kw), jnp.asarray(x), causal,
                                       jnp.asarray(ts), key)
    noise = torch_pairs(jax_mid_noise(key, 2, (1, 3, 4, 5, 1)))
    out = resnet.unet_mid_block_3d_apply(p, t(x), causal, t(ts), noise=noise)
    assert_close(out, ref, RTOL, f"mid block {dims}")
    assert resnet.conv_launches(p) == 4


def test_init_blocks_follows_the_jax_distributions():
    cfg = resnet.ResnetBlock3DConfig(dims=(2, 1), in_channels=16, out_channels=32, norm_layer=
                                     resnet.NormLayerType.GROUP_NORM, inject_noise=True)
    p = resnet.init_blocks_(resnet.ResnetBlock3D(cfg, device=CPU), torch.Generator().manual_seed(0))
    assert p.conv1.conv1.weight.abs().max() <= (16 * 9) ** -0.5 and torch.all(p.conv1.conv1.bias == 0)
    assert p.conv1.conv2.weight.abs().max() <= (32 * 3) ** -0.5 and torch.all(p.conv1.conv2.bias == 0)
    assert torch.all(p.norm1.weight == 1) and torch.all(p.per_channel_scale1 == 0)
    assert p.conv_shortcut.weight.abs().max() <= 16 ** -0.5 and torch.all(p.norm3.bias == 0)
    jp = jres.init_resnet_block_3d(jax.random.PRNGKey(0), jres.ResnetBlock3DConfig(
        dims=(2, 1), in_channels=16, out_channels=32, norm_layer=jres.NormLayerType.GROUP_NORM, inject_noise=True))
    assert port_shapes(p) == {k: str(v.shape) for k, v in flatten_tree(jp).items()}


# ---------------------------------------------------------------- encoder and decoder

SMALL_DEFAULT = (
    ("res_x", 1),
    ("compress_space_res", {"multiplier": 2}),
    ("res_x", 1),
    ("compress_time_res", {"multiplier": 2}),
    ("compress_all_res", {"multiplier": 1}),
    ("res_x", 1),
)
# Each residual compress_*_res replaced by its strided compress_* and a res_x_y.
SMALL_STRIDED = (
    ("res_x", 1),
    ("compress_space", {}),
    ("res_x_y", {"multiplier": 2}),
    ("compress_time", {}),
    ("res_x_y", {"multiplier": 2}),
    ("compress_all", {}),
    ("res_x", 1),
)


def _encoder_cfgs(blocks, norm, pad):
    kw = dict(out_channels=16, blocks=blocks, norm_num_groups=8)
    return (full_vae.FullVideoEncoderConfig(norm_layer=resnet.NormLayerType(norm),
                                            spatial_padding_mode=resnet.PaddingModeType(pad), **kw),
            jfull.FullVideoEncoderConfig(norm_layer=jres.NormLayerType(norm),
                                         spatial_padding_mode=jres.PaddingModeType(pad), **kw))


@pytest.mark.parametrize("blocks,norm,pad", [(SMALL_DEFAULT, "pixel_norm", "zeros"),
                                             (SMALL_STRIDED, "group_norm", "zeros"),
                                             (SMALL_STRIDED, "pixel_norm", "reflect")],
                         ids=["default_vocabulary", "strided_group_norm", "strided_reflect"])
def test_full_encoder_matches_jax(blocks, norm, pad):
    cfg, jcfg = _encoder_cfgs(blocks, norm, pad)
    assert [p[2:] for p in cfg.plan] == [p[2:] for p in jcfg.plan]
    tree = random_tree(full_vae.FullVideoEncoder(cfg, device="meta"), 19)
    enc = full_video_encoder_from_numpy(tree, cfg, device=CPU)
    # The residual space-to-depth needs sizes its strides divide; the strided
    # convs take ragged ones.
    size = (32, 48) if blocks is SMALL_DEFAULT else (36, 44)
    video = np.clip(x_of((1, 3, 9, *size), 20) * 0.5, -1, 1)
    ref = jfull.full_video_encoder_apply(jtree(tree), jcfg, jnp.asarray(video))
    out = full_vae.full_video_encoder_apply(enc, t(video))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert_close(out, ref, RTOL, f"encoder {norm} {pad}")
    launches = full_vae.conv_launches(cfg)
    assert launches["strided"] == (3 if blocks is SMALL_STRIDED else 0)
    assert launches["all"] == sum(isinstance(m, conv.Conv3d) for m in enc.modules())
    with pytest.raises(ValueError, match="always causal"):
        full_vae.full_video_encoder_apply(enc, t(video), causal=False)
    with pytest.raises(ValueError, match="1 \\+ 8\\*k"):
        full_vae.full_video_encoder_apply(enc, t(video[:, :, :8]))


def test_full_encoder_config_matches_jax():
    cfg, jcfg = full_vae.FullVideoEncoderConfig(), jfull.FullVideoEncoderConfig()
    assert [(n, c, i, o) for n, c, i, o in cfg.plan] == [(n, c, i, o) for n, c, i, o in jcfg.plan]
    assert cfg.conv_out_channels == jcfg.conv_out_channels == 129 and cfg.final_channels == 2048
    for log_var, want in (("per_channel", 256), ("constant", 129), ("none", 128)):
        assert full_vae.FullVideoEncoderConfig(latent_log_var=log_var).conv_out_channels == want
    enc = full_vae.FullVideoEncoder(cfg, device="meta")
    assert port_shapes(enc) == jax_init_shapes(jfull.init_full_video_encoder, jcfg)
    with pytest.raises(ValueError, match="Unknown encoder block"):
        full_vae.FullVideoEncoderConfig(blocks=(("res_y", 1),)).plan


SMALL_DECODER = (
    ("res_x", {"num_layers": 1, "inject_noise": True}),
    ("compress_all", {"residual": True, "multiplier": 2}),
    ("res_x_y", {"multiplier": 2}),
    ("compress_time", {"multiplier": 1}),
    ("res_x", {"num_layers": 2, "inject_noise": True}),
)


def _decoder_cfgs(tc, norm):
    kw = dict(in_channels=16, patch_size=2, blocks=SMALL_DECODER, norm_num_groups=8, timestep_conditioning=tc)
    return (full_vae.FullVideoDecoderConfig(norm_layer=resnet.NormLayerType(norm), **kw),
            jfull.FullVideoDecoderConfig(norm_layer=jres.NormLayerType(norm), **kw))


def _jax_decoder_noise(key, sample_shape, tc):
    """The JAX decoder's draws (full_vae.py:324-334, :353-355) for
    SMALL_DECODER on a (1, 16, 2, 3, 4) latent: the decode noise and, per up
    block with injected noise, its mid block's pairs."""
    k_decode, k_blocks = jax.random.split(key)
    decode = jax.random.normal(k_decode, sample_shape, jnp.float32) if tc else None
    k_blocks, k0 = jax.random.split(k_blocks)
    first = jax_mid_noise(k0, 2, (1, 2, 3, 4, 1))  # res_x x2 at the latent's size
    k_blocks, k4 = jax.random.split(k_blocks)
    last = jax_mid_noise(k4, 1, (1, 5, 6, 8, 1))  # res_x after compress_time and compress_all
    return decode, [torch_pairs(first), None, None, None, torch_pairs(last)]


@pytest.mark.parametrize("tc,noise,norm", [(False, False, "pixel_norm"), (True, False, "group_norm"),
                                           (True, True, "pixel_norm"), (False, True, "group_norm")],
                         ids=["plain", "timestep", "timestep_noise", "noise"])
def test_full_decoder_matches_jax(tc, noise, norm):
    cfg, jcfg = _decoder_cfgs(tc, norm)
    assert cfg.initial_channels == jcfg.initial_channels == 64
    assert [p[2:] for p in cfg.plan] == [p[2:] for p in jcfg.plan]
    tree = random_tree(full_vae.FullVideoDecoder(cfg, device="meta"), 21)
    dec = full_video_decoder_from_numpy(tree, cfg, device=CPU)
    latent = x_of((1, 16, 2, 3, 4), 22)
    ts = [x_of((1, 4 * 64), 23) * 0.2, None, None, None, x_of((1, 4 * 16), 24) * 0.2] if tc else None
    last = x_of((1, 2 * 16), 25) * 0.2 if tc else None
    key = jax.random.PRNGKey(26) if noise else None
    ref = jfull.full_video_decoder_apply(jtree(tree), jcfg, jnp.asarray(latent),
                                         None if ts is None else [None if a is None else jnp.asarray(a) for a in ts],
                                         None if last is None else jnp.asarray(last), key)
    kwargs = {}
    if noise:
        decode, blocks = _jax_decoder_noise(key, latent.shape, tc)
        kwargs = {"decode_noise": None if decode is None else t(decode), "block_noise": blocks}
    out = full_vae.full_video_decoder_apply(dec, t(latent), None if ts is None else [None if a is None else t(a)
                                                                                    for a in ts],
                                            None if last is None else t(last), **kwargs)
    assert out.shape == ref.shape == (1, 3, 5, 12, 16)
    assert_close(out, ref, RTOL, f"decoder tc={tc} noise={noise}")


def test_full_decoder_generator_and_counts():
    cfg, _ = _decoder_cfgs(True, "pixel_norm")
    dec = full_vae.init_full_video_decoder_(full_vae.FullVideoDecoder(cfg, device=CPU),
                                           torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, prm in dec.named_parameters():
            if "per_channel_scale" in name:
                prm.fill_(0.1)
    latent = t(x_of((1, 16, 2, 3, 4), 27))
    a = full_vae.full_video_decoder_apply(dec, latent, generator=torch.Generator().manual_seed(3))
    b = full_vae.full_video_decoder_apply(dec, latent, generator=torch.Generator().manual_seed(3))
    c = full_vae.full_video_decoder_apply(dec, latent)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # conv_in, 2 per res block (1 + 2 + the res_x_y), the two upsamplers, conv_out
    assert full_vae.conv_launches(cfg) == {"all": 2 + 2 * 4 + 2, "strided": 0}
    assert sum(isinstance(m, conv.Conv3d) for m in dec.modules()) == 12
    assert torch.all(dec.last_scale_shift_table == 0) and torch.all(dec.per_channel_statistics.std_of_means == 1)
    for tc in (False, True):
        assert port_shapes(full_vae.FullVideoDecoder(full_vae.FullVideoDecoderConfig(timestep_conditioning=tc),
                                                     device="meta")) == \
            jax_init_shapes(jfull.init_full_video_decoder, jfull.FullVideoDecoderConfig(timestep_conditioning=tc))


def test_full_vae_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        full_vae.FullVideoEncoder(full_vae.FullVideoEncoderConfig())
