"""The resident serving loop (counterpart of scripts/serve.py): load once,
generate per request.

`python -m ltx2_tpu_torch.generate` builds its models for each run and
releases each when its phase is over, so every clip pays the weights' load
again. This entry point keeps the process and its models alive: `setup`
builds (or loads) what the launch's pipeline runs once, into a
`ResidentModels`, and every request runs `execute_request` on it, so a
steady request costs the generation alone.

Protocol: one JSON object per line on stdin (or --requests FILE), one JSON
response per line on stdout; blank and `#` lines are skipped, and the ids
count requests:

    {"prompt": "a red fox", "output": "/tmp/fox.y4m", "seed": 3}
    -> {"status": "ok", "id": 0, "output": "/tmp/fox.y4m", "artifacts": [...], "seconds": 10.4, "stats": [...]}

Request fields override the launch's settings: prompt, negative_prompt,
output, seed, height, width, num_frames, num_inference_steps, cfg_scale,
stg_scale, sampler, pipeline, fps, audio (a JSON boolean), tile_size and
skip_vae (a JSON boolean), the JAX server's names. Everything else
(checkpoint, files, --fp8-serving, --enhance-prompt, ...) is fixed at launch:
it defines the resident models. Each request is checked by the command
line's own checks (`generate.check_request`) before it runs: a refused
request, an unknown or mistyped field and audio without --audio at launch
come back as {"status": "error", "kind": "bad_request"}; a generation that
fails (a kernel that does not build or launch, the card out of memory) as
"kind": "server". Neither ends the process. An ok response adds the port's
per-clip stats ("stats", as `generate.main` prints them) to the JAX
server's fields; its "artifacts" are the files written (a `.mp4` without
ffmpeg on PATH: the MJPEG `.mp4`, `<base>.gif` and `<base>_frames.npz`,
whose writing the stats' `save_s` counts).

With --http PORT the same requests arrive as `POST /generate` JSON bodies
(HTTP 400 for a bad request, 411 without a Content-Length, 500 for a
server fault, 504 past --request-timeout, 404 elsewhere) and `GET /healthz`
answers 200. Requests run in the server's threads, serialized behind one
lock (the resident models own the card); a request whose client got its
504 while it waited for the lock is dropped, one already running finishes.
--http-host widens the bind address beyond loopback. Each request's random
streams come from torch.Generators seeded from its seed, so a served clip
equals `generate.main`'s for the same settings.

On several ranks (launched as `generate.py`'s layouts are, under torchrun
with --sp-devices, --tp-devices, --pp-stages, the VAE flags or
--auto-shard), rank 0 alone reads the requests (the lines or the HTTP
front) and checks each; it broadcasts the request, or that it was refused,
to every rank over a control group of its own (gloo, on the host), and
every rank runs the generation in lockstep (`execute_request`). Rank 0
alone writes the files and answers; the other ranks print nothing. The end
of the input, or rank 0's shutdown, is broadcast too, and every rank exits
0. A refused request never reaches the other ranks' models.

    python -m ltx2_tpu_torch.serve --pipeline distilled --checkpoint ckpt.safetensors \\
        --spatial-upscaler up.safetensors --gemma-dir gemma/ --fp8-serving < requests.jsonl
    python -m ltx2_tpu_torch.serve --device cpu --layers 1 --height 64 --width 64 --frames 9 --http 8080
    torchrun --nproc-per-node 2 -m ltx2_tpu_torch.serve --pp-stages 2 --dist-backend gloo < requests.jsonl
"""

from __future__ import annotations

import argparse
import copy
import datetime
import json
import os
import sys
import tempfile
import time
from typing import Optional

from ltx2_tpu_torch import generate

# Per-request fields (everything else is the resident configuration), the
# JAX server's names and types.
REQUEST_FIELDS = {
    "prompt": str,
    "negative_prompt": str,
    "output": str,
    "seed": int,
    "height": int,
    "width": int,
    "num_frames": int,
    "num_inference_steps": int,
    "cfg_scale": float,
    "stg_scale": float,
    "sampler": str,
    "pipeline": str,
    "fps": float,
    "audio": bool,
    "tile_size": int,
    "skip_vae": bool,
}
# Request fields whose setting has another name in the port's parser.
FIELD_DEST = {"num_frames": "frames"}
# How long the other ranks wait for rank 0's next message: a server may idle.
CONTROL_TIMEOUT = datetime.timedelta(days=30)


class Control:
    """Rank 0's messages to the other ranks: each request it takes (its
    checked settings, or None when it refused it) and the shutdown, broadcast
    over a gloo group of the whole world (host memory: it carries no
    tensor of the models). A world of one rank needs none: `send` does
    nothing."""

    def __init__(self):
        import torch.distributed as dist

        from ltx2_tpu_torch.parallel.runtime import world

        self.rank, self.world = world()
        self.group = None
        if self.world > 1:
            self.group = dist.new_group(list(range(self.world)), backend="gloo", timeout=CONTROL_TIMEOUT)

    def _broadcast(self, message):
        import torch.distributed as dist

        box = [message]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def send(self, message) -> None:
        """Rank 0: `message` to every other rank."""
        if self.group is not None:
            self._broadcast(message)

    def receive(self):
        """Another rank: rank 0's next message."""
        return self._broadcast(None)


def _log(msg: str, *fargs) -> None:
    print("serve: " + (msg % fargs if fargs else msg), file=sys.stderr, flush=True)


def _positive_float(s: str) -> float:
    """argparse type of --request-timeout: 0 is refused, not taken for 'no
    timeout'."""
    v = float(s)
    if v <= 0:
        raise argparse.ArgumentTypeError(f"must be > 0 (got {s}); omit the flag to disable the timeout")
    return v


def build_parser() -> argparse.ArgumentParser:
    """`generate.build_parser()`'s settings and the server's own flags. A
    server makes one clip a request: the command line's `--requests N`
    (clips) gives way to the requests file."""
    p = argparse.ArgumentParser(description="ltx2-tpu-torch serving loop (JSON lines in, JSON lines out)",
                                parents=[generate.build_parser()], add_help=False, conflict_handler="resolve")
    p.add_argument("--requests", dest="requests_file", default="-",
                   help="requests file (a JSON object a line); '-' = stdin")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve HTTP instead of stdin: POST /generate with the same JSON request body (one generation "
                        "at a time, behind a lock), GET /healthz for liveness; port 0 picks a free port (logged)")
    p.add_argument("--http-host", default="127.0.0.1",
                   help="bind address for --http (default loopback; 0.0.0.0 accepts remote clients)")
    p.add_argument("--request-timeout", type=_positive_float, default=None, metavar="SEC",
                   help="HTTP only: reply 504 when a request (its wait for the lock included) exceeds SEC; a request "
                        "still waiting is dropped, a running generation finishes")
    p.add_argument("--warmup", action="store_true",
                   help="run one generation with the launch's settings before taking requests")
    p.add_argument("--warmup-shapes", default=None,
                   help="comma-separated HxWxF shapes generated once each at startup (e.g. '512x768x57,512x768x121')")
    p.set_defaults(requests=1)
    return p


def apply_request(base_args, request: dict):
    """The launch's settings with the request's fields over them, checked as
    the command line checks them (`generate.check_request`, which also
    rounds a two-stage resolution up to a multiple of 64). Raises
    ValueError (or NotImplementedError) for a request to refuse."""
    args = copy.copy(base_args)
    for key, value in request.items():
        if key not in REQUEST_FIELDS:
            raise ValueError(f"unknown request field {key!r} (allowed: {sorted(REQUEST_FIELDS)})")
        field_type = REQUEST_FIELDS[key]
        if field_type is bool:
            # bool("false") is True: anything but a JSON boolean is refused.
            if not isinstance(value, bool):
                raise ValueError(f"field {key!r} must be a JSON boolean, got {value!r}")
            setattr(args, FIELD_DEST.get(key, key), value)
        else:
            setattr(args, FIELD_DEST.get(key, key), field_type(value))
    # The audio models are resident only when the server was launched with
    # --audio (setup decided what to build).
    if args.audio and not base_args.audio:
        raise ValueError("request asks for audio but the server was launched without --audio (audio models are not "
                         "resident); restart with --audio")
    if args.pipeline == "a2vid" and base_args.pipeline != "a2vid" and not base_args.audio:
        raise ValueError("a2vid needs the audio models resident; launch with --audio")
    generate.check_request(args)
    return args


def _actual_outputs(requested: str) -> list:
    """The files a request wrote, the JAX server's candidates: the video,
    the no-ffmpeg `<base>.avi`, `<base>.gif` and `<base>_frames.npz`,
    `<base>_latent.npz` with skip_vae, `<base>.wav`."""
    base = requested.rsplit(".", 1)[0]
    candidates = [requested, base + ".avi", base + ".gif", base + "_frames.npz", base + "_latent.npz",
                  base + ".wav"]
    return [c for c in dict.fromkeys(candidates) if os.path.exists(c)]


def _warm(args, models, ledger, label: str) -> None:
    """One generation on `args` into a throwaway .y4m (its files deleted)."""
    wa = copy.copy(args)
    fd, wa.output = tempfile.mkstemp(suffix=".y4m", prefix="warmup_")
    os.close(fd)
    t0 = time.perf_counter()
    try:
        generate.execute_request(wa, models, ledger)
    finally:
        for artifact in _actual_outputs(wa.output):
            os.unlink(artifact)
    _log("%s in %.1f s", label, time.perf_counter() - t0)


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        generate.check_request(args)
    except ValueError as err:
        parser.error(str(err))
    t0 = time.perf_counter()
    models, ledger = generate.setup(args)
    control = Control()
    if control.rank == 0:
        _log("models resident in %.1f s (%.2f GB of weights)", time.perf_counter() - t0, models.weight_gb())

    if args.warmup:
        _warm(args, models, ledger, "warmup generation")
    if args.warmup_shapes:
        for shape in args.warmup_shapes.split(","):
            wa = copy.copy(args)
            wa.height, wa.width, wa.frames = (int(v) for v in shape.strip().split("x"))
            _warm(wa, models, ledger, f"warmed {shape.strip()}")

    if control.rank != 0:
        follow(models, ledger, control)
        return
    try:
        if args.http is not None:
            serve_http(args, models, ledger, control)
        else:
            serve_lines(args, models, ledger, control)
    finally:
        control.send({"shutdown": True})


def follow(models, ledger, control: Control) -> None:
    """A rank other than 0: every request rank 0 takes, run in lockstep
    with it (its response unused), until the shutdown."""
    while True:
        message = control.receive()
        if message.get("shutdown"):
            return
        if message["args"] is not None:
            run_request(message["args"], models, ledger, 0)


def serve_lines(args, models, ledger, control: Control) -> None:
    """The line protocol on stdin or --requests: a response a request."""
    stream = sys.stdin if args.requests_file == "-" else open(args.requests_file, encoding="utf-8")
    req_id = 0  # counts requests (comment and blank lines take no id)
    try:
        for line in stream:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                request = json.loads(line)
                if not isinstance(request, dict):
                    raise ValueError("a request must be a JSON object")
                response = handle_request(args, models, ledger, request, req_id, control)
            except Exception as exc:  # noqa: BLE001 - a bad line must not end the server
                control.send({"args": None})
                response = {"status": "error", "kind": "bad_request", "id": req_id,
                            "error": f"{type(exc).__name__}: {exc}", "seconds": 0.0}
            req_id += 1
            print(json.dumps(response), flush=True)
    finally:
        if stream is not sys.stdin:
            stream.close()


def handle_request(args, models, ledger, request: dict, req_id: int, control: Optional[Control] = None) -> dict:
    """One generation: the request in, its response out; never raises (the
    error response is the contract of both fronts). "kind" says whose fault
    an error is: "bad_request" (the request failed `apply_request`) or
    "server" (the generation failed). With `control` the checked request's
    settings, or its refusal, go to the other ranks first."""
    t0 = time.perf_counter()
    try:
        req_args = apply_request(args, request)
    except Exception as exc:  # noqa: BLE001 - a bad request must not end the server
        if control is not None:
            control.send({"args": None})
        return {"status": "error", "kind": "bad_request", "id": req_id, "error": f"{type(exc).__name__}: {exc}",
                "seconds": round(time.perf_counter() - t0, 2)}
    if control is not None:
        control.send({"args": req_args})
    return run_request(req_args, models, ledger, req_id, t0)


def run_request(req_args, models, ledger, req_id: int, t0: Optional[float] = None) -> dict:
    """`execute_request` on checked settings -> the response."""
    t0 = time.perf_counter() if t0 is None else t0
    try:
        _, stats = generate.execute_request(req_args, models, ledger)
        return {"status": "ok", "id": req_id, "output": req_args.output,
                "artifacts": _actual_outputs(req_args.output), "seconds": round(time.perf_counter() - t0, 2),
                "stats": stats}
    except Exception as exc:  # noqa: BLE001 - a device fault must not end residency
        return {"status": "error", "kind": "server", "id": req_id, "error": f"{type(exc).__name__}: {exc}",
                "seconds": round(time.perf_counter() - t0, 2)}


def make_http_server(args, models, ledger, control: Optional[Control] = None):
    """A ThreadingHTTPServer on args.http (0: a free port): POST /generate
    with the line protocol's JSON body, GET /healthz. Generations serialize
    behind one lock."""
    import queue
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    gen_lock = threading.Lock()
    counter = {"id": 0}

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server's name)
            if self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            else:
                self._reply(404, {"status": "error", "error": "not found"})

        def do_POST(self):  # noqa: N802
            if self.path != "/generate":
                self._reply(404, {"status": "error", "error": "not found"})
                return
            try:
                # A length-less (or chunked) POST would read as {} and run a
                # generation on the launch's settings: refused.
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0:
                    self._reply(411, {"status": "error", "kind": "bad_request",
                                      "error": "POST /generate requires a positive Content-Length (chunked bodies "
                                               "are not supported)"})
                    return
                request = json.loads(self.rfile.read(length))
                if not isinstance(request, dict):
                    raise ValueError("request body must be a JSON object")
            except Exception as exc:  # noqa: BLE001
                self._reply(400, {"status": "error", "kind": "bad_request", "error": f"{type(exc).__name__}: {exc}"})
                return

            def generate_locked(abandoned=None):
                with gen_lock:
                    # A request whose client already got its 504 while it
                    # waited here is dropped; a running one is not stopped.
                    if abandoned is not None and abandoned.is_set():
                        return None
                    req_id = counter["id"]
                    counter["id"] += 1
                    return handle_request(args, models, ledger, request, req_id, control)

            timeout = getattr(args, "request_timeout", None)
            if timeout is not None:
                box: queue.Queue = queue.Queue(maxsize=1)
                abandoned = threading.Event()
                threading.Thread(target=lambda: box.put(generate_locked(abandoned)), daemon=True).start()
                try:
                    response = box.get(timeout=timeout)
                except queue.Empty:
                    abandoned.set()
                    self._reply(504, {"status": "error", "kind": "timeout",
                                      "error": f"generation exceeded --request-timeout {timeout}s (a running "
                                               "generation runs to completion; a waiting one is dropped)"})
                    return
            else:
                response = generate_locked()
            if response["status"] == "ok":
                code = 200
            else:
                code = 400 if response.get("kind") == "bad_request" else 500
            self._reply(code, response)

        def log_message(self, fmt, *fargs):
            _log("http: " + fmt, *fargs)

    return ThreadingHTTPServer((getattr(args, "http_host", "127.0.0.1"), args.http), Handler)


def serve_http(args, models, ledger, control: Optional[Control] = None) -> None:
    server = make_http_server(args, models, ledger, control)
    _log("HTTP on http://%s:%d (POST /generate, GET /healthz)", *server.server_address[:2])
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    import torch.distributed as dist

    main()
    if dist.is_initialized():  # leave no backend threads running into the interpreter's exit
        dist.destroy_process_group()
