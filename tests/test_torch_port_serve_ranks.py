"""The resident server on several ranks: `python -m ltx2_tpu_torch.serve`
launched as 2 gloo ranks on the CPU (the launcher's environment, the
process group through a file in tmp_path) with --pp-stages 2, from a tiny
checkpoint (an fp32 2-block DiT and the decoder), against the one-process
server on the same requests:

- rank 0 answers every request with the one-process server's JSON lines
  (ids, statuses, kinds, outputs) and writes the files, the frames within 2
  levels of the one-process server's (the same DiT, its blocks on two
  ranks); the other rank prints nothing;
- a line that does not parse, an unknown field and a request the command
  line's checks refuse come back as bad requests without reaching the
  other rank's models, and the server goes on;
- the end of the input ends every rank with exit code 0.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.test_torch_port_parallel_cli import checkpoint  # noqa: F401 (the fixture)
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _requests(directory) -> str:
    path = os.path.join(directory, "requests.jsonl")
    lines = [json.dumps({"output": os.path.join(directory, "a.mp4"), "seed": 1}),
             "not json",
             json.dumps({"output": os.path.join(directory, "x.mp4"), "bogus": 1}),
             json.dumps({"output": os.path.join(directory, "y.mp4"), "audio": True}),
             "# a comment",
             json.dumps({"output": os.path.join(directory, "b.mp4"), "seed": 2, "num_inference_steps": 1})]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _serve(checkpoint, directory, world: int, *layout):  # noqa: F811
    """The server's stdout lines on each rank (one process without a world)."""
    argv = ["--pipeline", "text-to-video", "--device", "cpu", "--checkpoint", checkpoint, "--num-inference-steps",
            "2", "--height", "64", "--width", "128", "--frames", "9", "--dtype", "float32", "--requests",
            _requests(directory), *layout]
    procs = []
    for rank in range(world):
        env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
        extra = []
        if world > 1:
            env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
            extra = ["--dist-backend", "gloo", "--dist-init", f"file://{os.path.join(directory, 'pg_init')}"]
        procs.append(subprocess.Popen([sys.executable, "-m", "ltx2_tpu_torch.serve", *argv, *extra], cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=400) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [out for out, _ in outs]


def _comparable(response: dict) -> dict:
    """A response without its timings and paths' directory."""
    out = {k: v for k, v in response.items() if k not in ("seconds", "stats", "artifacts", "output")}
    out["files"] = sorted(os.path.basename(a) for a in response.get("artifacts", []))
    out["error"] = response.get("error", "").split(":")[0]
    return out


def test_server_on_2_ranks_answers_as_one_process(checkpoint, tmp_path):  # noqa: F811
    one, two = tmp_path / "one", tmp_path / "two"
    one.mkdir()
    two.mkdir()
    (ref_out,) = _serve(checkpoint, str(one), 1)
    outs = _serve(checkpoint, str(two), 2, "--pp-stages", "2")
    assert outs[1] == ""  # rank 0 alone answers
    ref = [json.loads(line) for line in ref_out.strip().splitlines()]
    got = [json.loads(line) for line in outs[0].strip().splitlines()]
    assert [r["id"] for r in got] == list(range(5))
    assert [(r["status"], r.get("kind")) for r in got] == [("ok", None), ("error", "bad_request"),
                                                           ("error", "bad_request"), ("error", "bad_request"),
                                                           ("ok", None)]
    assert [_comparable(r) for r in got] == [_comparable(r) for r in ref]
    for name in ("a", "b"):
        with np.load(one / f"{name}_frames.npz") as a, np.load(two / f"{name}_frames.npz") as b:
            ref_frames, frames = a["frames"], b["frames"]
        diff = np.abs(frames.astype(int) - ref_frames.astype(int))
        assert frames.shape == ref_frames.shape == (9, 64, 128, 3) and diff.max() <= 2, diff.max()
    assert not (two / "x.mp4").exists() and not (two / "y.mp4").exists()
