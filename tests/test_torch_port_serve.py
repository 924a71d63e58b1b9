"""The port's resident serving loop (ltx2_tpu_torch/serve.py) on the CPU:

- `apply_request` against `scripts/serve.py::apply_request` on the same
  request dicts: field coercion, JSON-boolean strictness, unknown fields,
  audio without --audio at launch, a2vid without the audio models, the
  two-stage %64 rounding, num_frames onto the port's `frames` (the same
  settings, or the same error class naming the same field);
- a JSON-lines run of `serve.main` at --layers 1, 64x64x9 from a requests
  file: comment lines, two good requests of different seeds, a bad field, a
  .mp4 output without ffmpeg (bad_request, before any generation) and a
  switch to text-to-video: the statuses, kinds and ids (ids count
  requests), each served clip's file byte for byte `generate.main`'s for
  the same settings, and the DiT built once (setup) for all of them;
- the HTTP front on port 0 in a thread: /healthz 200, /generate 200, a bad
  field 400, no Content-Length 411, an unknown path 404, a server fault
  500 with the next request served, and --request-timeout 504 with a
  request queued behind the lock dropped; --request-timeout 0 refused at
  parsing.
"""

import argparse
import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from ltx2_tpu_torch import generate, serve
from ltx2_tpu_torch.utils import video_io
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

TINY = ["--device", "cpu", "--layers", "1", "--height", "64", "--width", "64", "--frames", "9"]


def _jax_serve():
    from scripts import serve as jserve

    return jserve


def _launch(pipeline="one-stage", height=480, width=704):
    jserve = _jax_serve()
    jargs = jserve.generate._apply_reference_compat(jserve.build_parser().parse_args(
        ["--placeholder", "--no-gemma", "--pipeline", pipeline, "--height", str(height), "--width", str(width)]))
    args = serve.build_parser().parse_args(["--pipeline", pipeline, "--height", str(height), "--width", str(width),
                                            "--device", "cpu", "--output", "x.y4m"])
    generate.check_request(args, output=False)
    return jargs, args


REQUESTS = [
    {"seed": "7", "height": "512", "width": 768.0, "cfg_scale": "4.5", "fps": 12, "num_inference_steps": 3},
    {"num_frames": 57, "stg_scale": "1.5", "sampler": "heun", "tile_size": "256", "prompt": None},
    {"pipeline": "two-stage"},
    {"pipeline": "two-stage", "height": 100, "width": 130},
    {"pipeline": "text-to-video", "height": 100},
    {"skip_vae": True, "output": "y.y4m", "negative_prompt": None},
]
REFUSED = [({"audio": "false"}, "'audio'"), ({"skip_vae": 1}, "'skip_vae'"), ({"bogus": 1}, "'bogus'"),
           ({"audio": True}, "--audio"), ({"pipeline": "a2vid"}, "--audio"), ({"seed": "x"}, "invalid literal")]


@pytest.mark.parametrize("request_", REQUESTS, ids=range(len(REQUESTS)))
def test_apply_request_matches_jax(request_):
    jserve = _jax_serve()
    jargs, args = _launch()
    request_ = {k: v for k, v in request_.items() if v is not None}
    want = jserve.apply_request(jargs, request_)
    got = serve.apply_request(args, request_)
    for key in request_:
        dest = serve.FIELD_DEST.get(key, key)
        assert getattr(got, dest) == getattr(want, key), key
    assert (got.height, got.width) == (want.height, want.width)
    assert (args.height, args.width, args.pipeline) == (480, 704, "one-stage")  # the launch's settings untouched


@pytest.mark.parametrize("request_,word", REFUSED, ids=[w for _, w in REFUSED])
def test_apply_request_refuses_as_jax(request_, word):
    jserve = _jax_serve()
    jargs, args = _launch()
    with pytest.raises(ValueError) as want:
        jserve.apply_request(jargs, request_)
    with pytest.raises(ValueError) as got:
        serve.apply_request(args, request_)
    assert word in str(want.value) and word in str(got.value)


def test_request_fields_are_the_jax_servers():
    jserve = _jax_serve()
    assert serve.REQUEST_FIELDS == jserve.REQUEST_FIELDS
    _, args = _launch()
    for key in serve.REQUEST_FIELDS:
        assert hasattr(args, serve.FIELD_DEST.get(key, key)), key
    assert serve.build_parser().parse_args([]).requests == 1  # one clip a request
    jparser, parser = jserve.build_parser(), serve.build_parser()
    for flag in ("--requests", "--http", "--http-host", "--request-timeout", "--warmup", "--warmup-shapes"):
        assert flag in jparser._option_string_actions and flag in parser._option_string_actions, flag
    with pytest.raises(SystemExit):
        parser.parse_args(["--request-timeout", "0"])
    with pytest.raises(argparse.ArgumentTypeError):
        serve._positive_float("-1")


def test_port_refusals_are_bad_requests(monkeypatch):
    """What the command line refuses, a request gets back as bad_request:
    a .mp4 without ffmpeg, an explicit prompt without a tokenizer, an
    unknown pipeline, a loop option on a flow without it."""
    monkeypatch.setattr(video_io.shutil, "which", lambda name: None)
    _, args = _launch("distilled", 512, 768)
    for request_, word in (({"output": "o.mp4"}, "ffmpeg"), ({"prompt": "a fox"}, "tokenizer.json"),
                           ({"pipeline": "nope"}, "--pipeline"), ({"stg_scale": 1.0}, "--stg-scale"),
                           ({"sampler": "ddim"}, "--sampler")):
        response = serve.handle_request(args, None, None, request_, 3)
        assert response["status"] == "error" and response["kind"] == "bad_request" and response["id"] == 3
        assert word in response["error"], response


def test_json_lines_run(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(video_io.shutil, "which", lambda name: None)
    built = []
    make_dit = generate.make_dit

    def counted(*args, **kwargs):
        built.append(args[0])
        return make_dit(*args, **kwargs)

    monkeypatch.setattr(generate, "make_dit", counted)
    a, b, c = (str(tmp_path / f"{n}.y4m") for n in "abc")
    lines = ["# a comment line", "", json.dumps({"output": a, "seed": 1}), "# another",
             json.dumps({"output": b, "seed": 2}), json.dumps({"output": a, "no_such_field": 1}),
             json.dumps({"output": str(tmp_path / "d.mp4")}), "[1, 2]",
             json.dumps({"output": c, "seed": 1, "pipeline": "text-to-video"})]
    requests = tmp_path / "requests.jsonl"
    requests.write_text("\n".join(lines) + "\n")
    launch = TINY + ["--pipeline", "one-stage", "--num-inference-steps", "2", "--requests", str(requests)]
    serve.main(launch)
    responses = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["id"] for r in responses] == list(range(6))
    assert [r["status"] for r in responses] == ["ok", "ok", "error", "error", "error", "ok"]
    assert [r.get("kind") for r in responses[2:5]] == ["bad_request"] * 3
    assert "no_such_field" in responses[2]["error"] and "ffmpeg" in responses[3]["error"]
    assert responses[0]["artifacts"] == [a] and responses[5]["artifacts"] == [c]
    assert built == [1], "the DiT is built once, at setup"
    stats = responses[1]["stats"][0]
    assert stats["dit_init_s"] == 0.0 and stats["decoder_init_s"] == 0.0 and stats["seed"] == 2

    # Each served clip is generate.main's for the same settings, byte for byte.
    for served, seed, pipeline in ((a, 1, "one-stage"), (c, 1, "text-to-video")):
        cli = str(tmp_path / f"cli_{seed}_{pipeline}.y4m")
        generate.main(TINY + ["--pipeline", pipeline, "--num-inference-steps", "2", "--seed", str(seed),
                              "--output", cli])
        assert open(served, "rb").read() == open(cli, "rb").read(), (served, pipeline)
    assert open(a, "rb").read() != open(b, "rb").read()


@pytest.fixture(scope="module")
def http_server():
    args = serve.build_parser().parse_args(TINY + ["--pipeline", "one-stage", "--num-inference-steps", "1",
                                                   "--skip-vae", "--http", "0"])
    generate.check_request(args, output=False)
    models, ledger = generate.setup(args)
    server = serve.make_http_server(args, models, ledger)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield args, server.server_address[1]
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_http_front(http_server, tmp_path, monkeypatch):
    args, port = http_server
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as resp:
        assert resp.status == 200 and json.loads(resp.read()) == {"status": "ok"}
    code, ok = _post(port, {"output": str(tmp_path / "h.y4m"), "seed": 5})
    assert code == 200 and ok["status"] == "ok" and ok["artifacts"] == [str(tmp_path / "h_latent.npz")]
    code, bad = _post(port, {"no_such_field": 1})
    assert code == 400 and bad["kind"] == "bad_request" and "no_such_field" in bad["error"]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/generate")  # no body: no Content-Length
    raw = conn.getresponse()
    assert raw.status == 411 and json.loads(raw.read())["kind"] == "bad_request"
    conn.close()
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(urllib.request.Request(f"http://127.0.0.1:{port}/nope", data=b"{}"), timeout=30)
    assert err.value.code == 404

    real = generate.execute_request
    calls = {"n": 0}

    def flaky(req_args, models, ledger):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("CUDA out of memory (injected)")
        return real(req_args, models, ledger)

    monkeypatch.setattr(generate, "execute_request", flaky)
    code, resp = _post(port, {"output": str(tmp_path / "f.y4m"), "seed": 1})
    assert code == 500 and resp["kind"] == "server" and "out of memory" in resp["error"]
    code, resp = _post(port, {"output": str(tmp_path / "g.y4m"), "seed": 1})
    assert code == 200 and (tmp_path / "g_latent.npz").exists()

    release = threading.Event()

    def slow(req_args, models, ledger):
        release.wait(timeout=60)
        return real(req_args, models, ledger)

    monkeypatch.setattr(generate, "execute_request", slow)
    args.request_timeout = 0.3
    try:
        t0 = time.perf_counter()
        code, resp = _post(port, {"output": str(tmp_path / "s.y4m"), "seed": 2})
        assert code == 504 and resp["kind"] == "timeout" and time.perf_counter() - t0 < 10
        code, resp = _post(port, {"output": str(tmp_path / "q.y4m"), "seed": 4})  # queued behind the lock
        assert code == 504 and resp["kind"] == "timeout"
    finally:
        release.set()
        args.request_timeout = None
    monkeypatch.setattr(generate, "execute_request", real)
    deadline = time.monotonic() + 120
    while not (tmp_path / "s_latent.npz").exists():
        assert time.monotonic() < deadline, "the timed-out generation never finished"
        time.sleep(0.2)
    code, resp = _post(port, {"output": str(tmp_path / "t.y4m"), "seed": 3})
    assert code == 200 and resp["status"] == "ok"
    assert not (tmp_path / "q_latent.npz").exists()  # the queued request was dropped at the lock


def test_server_needs_cuda_unless_told(tmp_path, monkeypatch, capsys):
    """Without --device the server runs on cuda: with no card it stops at
    setup, before any request, and falls back to nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    requests = tmp_path / "r.jsonl"
    requests.write_text(json.dumps({"output": str(tmp_path / "a.y4m")}) + "\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--layers", "1", "--requests", str(requests)])
    assert capsys.readouterr().out == "" and not (tmp_path / "a.y4m").exists()


def test_runtime_lora_leaves_a_resident_dit_bit_for_bit(tmp_path):
    """A request that fuses a LoRA at run time (two-stage's distilled LoRA,
    ic-lora's) unfuses it only up to bf16's rounding: inside `resident`
    the weights it touches are written back bit for bit; outside, the
    unfuse's drift stays (the one-shot command line's behaviour)."""
    import dataclasses

    import numpy as np

    from ltx2_tpu_torch.loader.lora import LoRAConfig, fuse_lora_into_params, lora_targets, unfuse_lora_deltas
    from ltx2_tpu_torch.loader.safetensors_io import write_safetensors
    from tests.torch_port_util import CFG

    rng = np.random.default_rng(0)
    dit = generate.make_dit(1, torch.device("cpu"), base=dataclasses.replace(CFG, compute_dtype="bfloat16"))
    lora = {}
    for name in ("attn1.to_q", "ff.net.2"):  # the reference's FF name, ff.project_out in the port
        base = f"diffusion_model.transformer_blocks.0.{name}"
        weight = dit.get_parameter(f"transformer_blocks.0.{name.replace('net.2', 'project_out')}.weight")
        lora[f"{base}.lora_A.weight"] = torch.from_numpy(rng.standard_normal((4, weight.shape[1]), np.float32))
        lora[f"{base}.lora_B.weight"] = torch.from_numpy(rng.standard_normal((weight.shape[0], 4), np.float32))
    path = str(tmp_path / "lora.safetensors")
    write_safetensors(path, lora)
    config = [LoRAConfig(path, 0.7)]
    names = lora_targets(dit, config)
    assert sorted(names) == ["transformer_blocks.0.attn1.to_q.weight", "transformer_blocks.0.ff.project_out.weight"]
    before = {n: dit.get_parameter(n).detach().clone() for n in names}

    def fuse_and_unfuse():
        _, applied = fuse_lora_into_params(dit, config, return_deltas=True)
        unfuse_lora_deltas(dit, applied)

    with generate.resident(generate.ResidentModels()), generate._weights_restored(dit, config):
        fuse_and_unfuse()
    assert all(torch.equal(dit.get_parameter(n), before[n]) for n in names)
    with generate._weights_restored(dit, config):  # no resident models: nothing is kept
        fuse_and_unfuse()
    assert any(not torch.equal(dit.get_parameter(n), before[n]) for n in names)
