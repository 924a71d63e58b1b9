"""The layout advisor and its FLOP count (parallel/advisor.py,
utils/flops.py) against ltx2_tpu/parallel/advisor.py and
ltx2_tpu/utils/flops.py, and `--auto-shard` on the command line.

- `dit_step_flops` (video, audio-video, cached text K/V, rows) equal to the
  JAX package's;
- the volume formulas, `_allreduce_payload_units` (the port's sharding
  rules over a DiT on the meta device against JAX's over `eval_shape`),
  `enumerate_layouts`, `estimate_layout` and `choose` equal to the JAX
  package's when handed its constants (v5e peak and ICI bandwidth) where
  the two models agree (no PP, or PP2 without SP, and no TP without PP);
  elsewhere each departure of the port's model is the ratio or the overlap
  its schedule gives (a hop of n / sp tokens, m hops a stage, a blocking
  TP all-reduce);
- one test per ADVICE.md defect, the port's choice beside the JAX CLI's:
  the half-resolution stage 1 of distilled, a2vid's one guidance row, the
  PP x SP hop bytes; the pipeline classes' guidance and stage facts;
- `generate.apply_auto_shard`: a no-op without the flag, explicit layout
  flags win, the flags filled with the chosen layout, the route's
  bandwidth; the header peek.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import pytest

from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.parallel import advisor as jadvisor
from ltx2_tpu.utils import flops as jflops
from ltx2_tpu_torch import generate
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.parallel import advisor
from ltx2_tpu_torch.utils import flops
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONSTANTS = dict(peak_tflops=jadvisor.V5E_BF16_TFLOPS, bytes_per_s=jadvisor.V5E_ICI_BYTES_PER_S)
HALF_RES_STAGE_1 = {"distilled", "two-stage", "keyframe", "ic-lora", "a2vid", "ti2vid-hq"}
DISTILLED_LOOPS = {"distilled", "a2vid", "ic-lora"}  # CFGGuider(1.0): one guidance row
SMALL = dict(num_attention_heads=8, attention_head_dim=16, in_channels=16, out_channels=16, num_layers=4,
             cross_attention_dim=64, compute_dtype="bfloat16", remat=False)
AV = dict(SMALL, audio_heads=4, audio_head_dim=8, audio_in_channels=16, audio_out_channels=16, caption_channels=32)


def _configs():
    """(port, JAX) config pairs: the flagship, a small video DiT, a small
    audio-video DiT."""
    flag = advisor.flagship_serving_config()
    jflag = jadvisor.flagship_serving_config()
    return [(flag, jflag),
            (model.LTXModelConfig(caption_channels=None, **SMALL),
             jmodel.LTXModelConfig(model_type=jmodel.LTXModelType.VideoOnly, caption_channels=None, **SMALL)),
            (model.LTXModelConfig(model_type=model.LTXModelType.AudioVideo, **AV),
             jmodel.LTXModelConfig(model_type=jmodel.LTXModelType.AudioVideo, **AV))]


def test_flagship_config_and_token_count_are_the_jax_packages():
    flag, jflag = advisor.flagship_serving_config(), jadvisor.flagship_serving_config()
    for field in ("num_attention_heads", "attention_head_dim", "in_channels", "out_channels", "num_layers",
                  "cross_attention_dim", "caption_channels", "compute_dtype"):
        assert getattr(flag, field) == getattr(jflag, field), field
    for shape in ((121, 512, 768), (65, 640, 640), (9, 192, 192), (1, 64, 96)):
        assert advisor.video_token_count(*shape) == jadvisor.video_token_count(*shape)
    assert flops.H100_BF16_PEAK_TFLOPS == 989.0


@pytest.mark.parametrize("which", [0, 1, 2], ids=["flagship", "small", "av"])
def test_dit_step_flops_matches_jax(which):
    cfg, jcfg = _configs()[which]
    audio = 126 if cfg.is_av else 0
    for n, s, rows, cached in ((6144, 1024, 1, False), (1536, 256, 3, True), (96, 8, 2, False)):
        assert flops.dit_step_flops(cfg, n, s, audio, rows, cached) == \
            jflops.dit_step_flops(jcfg, n, s, audio, rows, cached)


@pytest.mark.parametrize("which", [0, 1, 2], ids=["flagship", "small", "av"])
def test_volume_formulas_match_jax(which):
    cfg, jcfg = _configs()[which]
    assert advisor._allreduce_payload_units(cfg) == jadvisor._allreduce_payload_units(jcfg)
    for rows, n, sp, stages, m in ((1, 6144, 2, 2, 1), (3, 1536, 4, 4, 3), (2, 96, 8, 2, 2)):
        assert advisor.sp_ring_bytes(cfg, rows, n, sp, 2) == jadvisor.sp_ring_bytes(jcfg, rows, n, sp, 2)
        # The port sends m hops a stage; the JAX schedule m + P - 2 (the same at P = 2).
        ours = advisor.pp_permute_bytes(cfg, rows, n, m, 2)
        assert ours * (m + stages - 2) == jadvisor.pp_permute_bytes(jcfg, rows, n, stages, m, 2) * m
        assert ours == jadvisor.pp_permute_bytes(jcfg, rows, n, 2, m, 2)
        assert advisor.ring_allreduce_wire_bytes(1e9, sp) == jadvisor.ring_allreduce_wire_bytes(1e9, sp)


@pytest.mark.parametrize("n_devices,tokens", [(8, 6144), (4, 1536), (8, 900), (6, 3600)])
def test_enumerate_estimate_and_choose_match_jax_with_its_constants(n_devices, tokens):
    """With the JAX constants every layout's compute time is the JAX
    advisor's; its wire bytes too, but for the pipeline's hops, which carry
    n / sp tokens m times where the JAX model charges n tokens m + P - 2
    times; it overlaps as the JAX model does, but for TP, whose all-reduce
    blocks here. Where none of these applies the estimate is the JAX
    advisor's, and on such a table `choose` ranks and justifies as it does."""
    cfg, jcfg = _configs()[0]
    assert advisor.enumerate_layouts(cfg, n_devices, tokens, (tokens // 4,)) == \
        jadvisor.enumerate_layouts(jcfg, n_devices, tokens, (tokens // 4,))
    for tp, sp, pp in advisor.enumerate_layouts(cfg, n_devices, tokens):
        for rows in (1, 2, 3):
            ours = advisor.estimate_layout(cfg, tokens, rows, tp, sp, pp, **JAX_CONSTANTS)
            ref = jadvisor.estimate_layout(jcfg, tokens, rows, tp, sp, pp)
            assert ours.compute_s == pytest.approx(ref.compute_s, rel=1e-12)
            hops = port_hops = 0
            if pp > 1:
                hops = jadvisor.pp_permute_bytes(jcfg, rows, tokens, pp, rows, 2)
                port_hops = hops * rows / ((rows + pp - 2) * sp)
            assert ours.wire_bytes == pytest.approx(ref.wire_bytes - hops + port_hops, rel=1e-12)
            assert ours.overlapped == (ref.overlapped and tp == 1)
            assert ours.step_s == pytest.approx(max(ours.compute_s, ours.comm_s) if ours.overlapped
                                                else ours.compute_s + ours.comm_s, rel=1e-12)
            if (pp == 1 and tp == 1) or (pp == 2 and sp == 1):
                assert dataclasses.astuple(ours) == pytest.approx(dataclasses.astuple(ref), rel=1e-12)
    for rows in (1, 2):
        best, table = advisor.choose(cfg, n_devices, tokens, rows=rows, **JAX_CONSTANTS)
        assert best == table[0] and [e.step_s for e in table] == sorted(e.step_s for e in table)
        assert {(e.tp, e.sp, e.pp) for e in table} == set(advisor.enumerate_layouts(cfg, n_devices, tokens))
    # Two ranks and heads TP cannot split: SP2 and PP2, on which the models agree.
    odd, jodd = (dataclasses.replace(c, num_attention_heads=31) for c in (cfg, jcfg))
    for rows in (1, 2, 3):
        best, table = advisor.choose(odd, 2, tokens, rows=rows, **JAX_CONSTANTS)
        jbest, jtable = jadvisor.choose(jodd, 2, tokens, rows=rows)
        assert [(e.tp, e.sp, e.pp) for e in table] == [(e.tp, e.sp, e.pp) for e in jtable]
        assert best.justification(tokens) == jbest.justification(tokens)


def _jax_cli():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import generate as jgenerate
    finally:
        sys.path.pop(0)
    return jgenerate


def _jax_args(**kw):
    defaults = dict(auto_shard=8, sp_devices=0, pp_stages=0, tp_devices=0, placeholder=False,
                    checkpoint="x.safetensors", num_frames=121, height=512, width=768, cfg_scale=3.0, stg_scale=0.0,
                    pipeline="distilled", audio=False, fps=24.0)
    defaults.update(kw)
    return argparse.Namespace(**defaults)


def _port_args(**kw):
    args = generate.build_parser().parse_args(["--pipeline", kw.pop("pipeline", "distilled")])
    for key, value in dict(dict(auto_shard=8, checkpoint=None, layers=48), **kw).items():
        setattr(args, key, value)
    return args


def test_defect_half_resolution_stage_1_constrains_sp_on_every_pipeline():
    """ADVICE.md, scripts/generate.py:715: the JAX CLI adds stage 1's token
    count for two-stage only. distilled at 640x640x65 on 8 ranks: 3600
    tokens, 900 at stage 1. The JAX CLI picks SP8, which 900 does not
    divide (its run fails at stage 1); the port's choice divides both, on
    every half-resolution pipeline, whose class states stage 1's tokens."""
    jgen = _jax_cli()
    jargs = _jax_args(num_frames=65, height=640, width=640)
    jgen.apply_auto_shard(jargs)
    jax_choice = (jargs.tp_devices, jargs.sp_devices, jargs.pp_stages)
    assert jargs.sp_devices == 8 and 900 % 8  # the JAX CLI's SP8 fails at stage 1
    for pipeline in generate.PIPELINE_CLASSES:
        counts = generate.pipeline_class(pipeline).stage_token_counts(65, 640, 640)
        assert counts == ((900,) if pipeline in HALF_RES_STAGE_1 else ()), pipeline
        args = _port_args(pipeline=pipeline, frames=65, height=640, width=640)
        generate.apply_auto_shard(args)
        sp = args.sp_devices or 1
        assert 3600 % sp == 0 and all(c % sp == 0 for c in counts), (pipeline, sp, jax_choice)
    # keyframe: a keyframe's tokens at each stage too (they are appended).
    assert generate.pipeline_class("keyframe").stage_token_counts(65, 640, 640, keyframes=2) == (900, 400, 100)


def test_defect_a2vid_counts_one_guidance_row():
    """ADVICE.md, scripts/generate.py:737: a2vid runs the distilled loops
    (one row) but the JAX CLI counts the CFG row at --cfg-scale > 1."""
    for pipeline in generate.PIPELINE_CLASSES:
        assert generate.pipeline_class(pipeline).CFG_ROW == (pipeline not in DISTILLED_LOOPS), pipeline
    jgen = _jax_cli()
    jargs = _jax_args(pipeline="a2vid", audio=True)
    jbest = jgen.apply_auto_shard(jargs)
    jrows2, _ = jadvisor.choose(jadvisor.flagship_serving_config(), 8, 6144, rows=2,
                                extra_sp_constraints=(126,))
    assert (jbest.tp, jbest.sp, jbest.pp) == (jrows2.tp, jrows2.sp, jrows2.pp)  # JAX modelled 2 rows
    cfg = advisor.flagship_serving_config()
    best = generate.apply_auto_shard(_port_args(pipeline="a2vid", cfg_scale=3.0))
    rows1, _ = advisor.choose(cfg, 8, 6144, rows=1, extra_sp_constraints=(1536, 126))
    assert (best.tp, best.sp, best.pp) == (rows1.tp, rows1.sp, rows1.pp)
    assert best.compute_s == pytest.approx(rows1.compute_s)
    assert best.compute_s < advisor.estimate_layout(cfg, 6144, 2, best.tp, best.sp, best.pp).compute_s


def test_defect_pp_hop_bytes_divide_by_sp():
    """ADVICE.md, advisor.py:221: under PP x SP a rank's hop carries its
    token shard; the JAX advisor charges the whole sequence. At PP2 the
    hop counts agree, so the hops' bytes are the JAX advisor's / SP."""
    cfg, jcfg = _configs()[0]
    for sp in (2, 4):
        ours = advisor.estimate_layout(cfg, 6144, 2, 1, sp, 2, **JAX_CONSTANTS)
        ref = jadvisor.estimate_layout(jcfg, 6144, 2, 1, sp, 2)
        ring = advisor.sp_ring_bytes(cfg, 2, 6144, sp, 2)
        assert ours.wire_bytes - ring == pytest.approx((ref.wire_bytes - ring) / sp)


def test_card_constants_and_routes():
    """The card's peak, NVLink 4 for nccl, the measured staged rate for
    gloo; the overlap table is the port's code's."""
    assert advisor.route_of_backend(None) == "nccl" and advisor.route_of_backend("nccl") == "nccl"
    assert advisor.route_of_backend("gloo", "cuda") == "gloo_staged"
    assert advisor.route_of_backend("gloo", "cpu") == "gloo"
    assert advisor.ROUTE_BYTES_PER_S["nccl"] == 450e9
    assert advisor.OVERLAPPABLE_COLLECTIVES == {"tp_allreduce": False, "sp_ppermute": True, "pp_ppermute": False}
    cfg = advisor.flagship_serving_config()
    slow = advisor.estimate_layout(cfg, 6144, 1, 2, 1, 1, bytes_per_s=advisor.GLOO_STAGED_BYTES_PER_S)
    fast = advisor.estimate_layout(cfg, 6144, 1, 2, 1, 1)
    assert slow.comm_s > fast.comm_s and not fast.overlapped
    assert fast.compute_s == pytest.approx(flops.dit_step_flops(cfg, 6144, 1024) / 2 / 989e12)


def test_apply_auto_shard_cli_semantics(capsys):
    """A no-op without the flag; explicit layout flags win; the flags are
    filled with a layout of N ranks that divides every constraint; the
    random DiT's --layers constrain PP; the choice and its justification
    go to stderr."""
    args = _port_args(auto_shard=0)
    assert generate.apply_auto_shard(args) is None and (args.tp_devices, args.sp_devices, args.pp_stages) == (0,) * 3
    args = _port_args(tp_devices=8)
    assert generate.apply_auto_shard(args) is None and args.tp_devices == 8 and args.sp_devices == 0
    assert "explicit layout flags win" in capsys.readouterr().err
    args = _port_args()
    best = generate.apply_auto_shard(args)
    assert (args.tp_devices or 1) * (args.sp_devices or 1) * (args.pp_stages or 1) == 8
    assert (best.tp, best.sp, best.pp) == ((args.tp_devices or 1), (args.sp_devices or 1), (args.pp_stages or 1))
    assert capsys.readouterr().err.startswith(f"--auto-shard: {best.name} over 8 chips at 6144 tokens")
    args = _port_args(layers=3, frames=9, height=64, width=64, pipeline="one-stage")
    generate.apply_auto_shard(args)
    assert 3 % (args.pp_stages or 1) == 0 and 8 % (args.sp_devices or 1) == 0
    for backend, route in ((None, "nccl"), ("gloo", "gloo_staged")):
        args = _port_args(dist_backend=backend, device=None)
        best = generate.apply_auto_shard(args)
        ref, _ = advisor.choose(advisor.flagship_serving_config(), 8, 6144, rows=1, extra_sp_constraints=(1536,),
                                bytes_per_s=advisor.ROUTE_BYTES_PER_S[route])
        assert best == ref


def test_peek_checkpoint_arch(tmp_path):
    """The header peek: the blocks from the tensor names, the heads from
    the metadata (top level, as the JAX peek reads it, or the reference
    layout's "transformer" entry); soft failure."""
    import numpy as np

    from ltx2_tpu.loader.safetensors_io import write_safetensors

    tensors = {f"model.diffusion_model.transformer_blocks.{i}.attn1.to_q.weight": np.zeros((4, 4), np.float32)
               for i in range(6)}
    for name, blob in (("top", '{"num_attention_heads": 8}'), ("nested", '{"transformer": {"num_attention_heads": 8}}')):
        path = str(tmp_path / f"{name}.safetensors")
        write_safetensors(path, tensors, metadata={"config": blob})
        assert advisor.peek_checkpoint_arch(path) == (6, 8)
        if name == "top":
            assert jadvisor.peek_checkpoint_arch(path) == (6, 8)
    assert advisor.peek_checkpoint_arch(str(tmp_path / "nope.st")) == (None, None)
