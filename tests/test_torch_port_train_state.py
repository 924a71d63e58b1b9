"""The port's training state (ltx2_tpu_torch/training/checkpoint.py) and
`train.main --save-state / --save-every / --resume` on the CPU.

A run cut after a saved step and resumed from that file gives the losses
and final weights of the uninterrupted run bit for bit (the batch indices
fast-forwarded, per-step generators `seed + 2 + i`, AdamW's moments and
count and the EMA restored); the file holds exactly the live tensors; a file
saved under another configuration (LoRA rank, trainable regex, EMA on or off)
is refused loudly; a failed write leaves the previous file whole.
"""

from __future__ import annotations

import os

import pytest
import torch

from ltx2_tpu_torch import train
from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile
from ltx2_tpu_torch.training import TrainBatch, TrainConfig, init_ema, make_optimizer, make_train_step
from ltx2_tpu_torch.training import checkpoint
from ltx2_tpu_torch.training.lora import add_lora_params_, lora_trainable_mask

# A 1-block placeholder DiT on 3 synthetic samples; a cosine schedule after a
# warmup step, weight decay and clipping, so that AdamW's count matters.
BASE = ["--placeholder", "--device", "cpu", "--layers", "1", "--steps", "4", "--lr", "1e-2", "--weight-decay",
        "0.01", "--warmup-steps", "1", "--lr-schedule", "cosine", "--synthetic-samples", "3", "--log-every", "100"]
RUNS = {
    "lora_ema": ["--synthetic", "2", "2", "2", "--lora-rank", "2", "--ema-decay", "0.5"],
    "av_trainable": ["--synthetic", "2", "2", "2", "--audio", "--trainable", r"attn1\.to_(q|k)"],
    "accum_batch": ["--synthetic", "2", "2", "2", "--lora-rank", "2", "--batch-size", "2", "--accum-steps", "2"],
}


@pytest.fixture(autouse=True)
def _one_thread():
    """The model here is tiny: one intra-op thread runs it fastest, above all
    when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Interrupted(Exception):
    pass


def _trained(res):
    return {n: p.detach().clone() for n, p in res["model"].named_parameters() if p.requires_grad}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_resumed_run_is_bitwise_the_uninterrupted_one(run, tmp_path):
    flags = BASE + RUNS[run]
    straight = train.main(flags)
    state = str(tmp_path / "state.safetensors")

    def crash(i, model, loss):
        if i == 2:  # after step 2's update, before its save: the file holds step 2
            raise Interrupted

    with pytest.raises(Interrupted):
        train.main(flags + ["--save-state", state, "--save-every", "2"], on_step=crash)
    assert not os.path.exists(state + ".tmp")
    resumed = train.main(flags + ["--resume", state])
    assert resumed["start"] == 2
    assert resumed["losses"] == straight["losses"][2:]
    want, got = _trained(straight), _trained(resumed)
    assert set(want) == set(got) and want
    for n in want:
        assert torch.equal(got[n], want[n]), n


def _small_run(rank: int = 2, ema: bool = True):
    """A model with adapters, its optimizer after two steps, its EMA."""
    model = train.make_model(1, torch.device("cpu"), 0, placeholder=True)
    add_lora_params_(model, torch.Generator().manual_seed(1), rank=rank, alpha=float(rank))
    lora_trainable_mask(model)
    params = [p for p in model.parameters() if p.requires_grad]
    tc = TrainConfig(learning_rate=1e-2)
    optimizer = make_optimizer(tc, params)
    step = make_train_step(model, optimizer, tc)
    batch = train.make_batch(train.synthetic_dataset(1, 2, 2, 1, model.cfg, 0), [0], torch.device("cpu"))
    assert isinstance(batch, TrainBatch)
    for i in range(2):
        step(batch, torch.Generator().manual_seed(i))
    return model, optimizer, (init_ema(params) if ema else None)


def test_saved_state_round_trips_bitwise(tmp_path):
    """Every live tensor (parameters, both moments, the EMA) and AdamW's
    count come back bit for bit into a fresh model and optimizer."""
    model, optimizer, ema = _small_run()
    path = str(tmp_path / "s.safetensors")
    checkpoint.save_train_state(path, 7, model, optimizer, ema, metadata={"seed": "0"})
    f = SafetensorsFile(path)
    assert f.metadata["train_state_step"] == "7" and f.metadata["seed"] == "0"
    n = len(optimizer.params)
    assert sum(k.startswith("param.") for k in f.keys()) == n and len(list(f.keys())) == 4 * n
    f.close()
    fresh, fresh_opt, fresh_ema = _small_run()
    with torch.no_grad():
        for p in fresh_opt.params:
            p.zero_()
    fresh_opt.count = 0
    assert checkpoint.load_train_state(path, fresh, fresh_opt, fresh_ema) == 7
    assert fresh_opt.count == optimizer.count == 2
    for a, b in zip(checkpoint._entries(model, optimizer, ema), checkpoint._entries(fresh, fresh_opt, fresh_ema)):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]


@pytest.mark.parametrize("mismatch", ["rank", "ema", "trainable"])
def test_another_configuration_is_refused(mismatch, tmp_path):
    model, optimizer, ema = _small_run()
    path = str(tmp_path / "s.safetensors")
    checkpoint.save_train_state(path, 2, model, optimizer, ema)
    if mismatch == "rank":
        other = _small_run(rank=3)
    elif mismatch == "ema":
        other = _small_run(ema=False)
    else:  # one adapter more frozen: another trainable set
        other_model, _, _ = _small_run()
        other_model.transformer_blocks[0].attn1.to_q.lora_A.requires_grad_(False)
        params = [p for p in other_model.parameters() if p.requires_grad]
        other = (other_model, make_optimizer(TrainConfig(), params), init_ema(params))
    with pytest.raises(ValueError, match="different configuration"):
        checkpoint.load_train_state(path, *other)


def test_resume_cli_refuses_another_configuration(tmp_path):
    state = str(tmp_path / "state.safetensors")
    flags = BASE[:BASE.index("--steps")] + ["--synthetic", "2", "2", "2"]
    train.main(flags + ["--steps", "1", "--lora-rank", "2", "--save-state", state])
    with pytest.raises(ValueError, match="different configuration"):
        train.main(flags + ["--steps", "2", "--lora-rank", "4", "--resume", state])
    with pytest.raises(ValueError, match="different configuration"):
        train.main(flags + ["--steps", "2", "--lora-rank", "2", "--ema-decay", "0.9", "--resume", state])


def test_failed_write_leaves_the_previous_file(tmp_path, monkeypatch):
    model, optimizer, ema = _small_run()
    path = str(tmp_path / "s.safetensors")
    checkpoint.save_train_state(path, 2, model, optimizer, ema)
    before = open(path, "rb").read()

    def broken(tmp, specs, metadata=None):
        with open(tmp, "wb") as fh:
            fh.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint, "write_safetensors_streaming", broken)
    with pytest.raises(OSError):
        checkpoint.save_train_state(path, 3, model, optimizer, ema)
    assert open(path, "rb").read() == before
