"""Persistent worker: one long-lived process serves many CLI invocations.

The port's copy of wgbs_tools_tpu/cli/worker.py. A fresh process of the
port pays, before its first kernel runs, for importing torch, creating the
CUDA context, loading the hand-written kernels' library (built once by
nvcc into build/, `_kernels.py`) and the host library, and each module's
first use. A worker pays that once: the second and every later invocation
of a device job runs in a process that is already warm.

Usage:
    wgbstools-torch worker serve [--socket PATH] [--warm] [--device D]
    wgbstools-torch worker run <cmd> [args...]     # run through the worker
    wgbstools-torch worker stop                    # ask the server to exit
    WGBS_TPU_WORKER=1 wgbstools-torch <cmd> ...    # transparent routing

Protocol (unix socket, single client at a time): the client sends one JSON
line {"engine": "torch", "argv": [ENGINE_TAG, ...], "cwd": "...",
"env": {WGBS_*...}} (a stop request: {"engine": "torch", "argv":
[ENGINE_TAG], "halt": true}); the server streams
framed output back — 1-byte type (1=stdout, 2=stderr, 0=exit) + 4-byte LE
length + payload — and the client replays frames onto its own streams and
exits with the command's return code. stdin is not forwarded.

Concurrency: requests are served STRICTLY ONE AT A TIME (device state is
process-global, so serializing is the correct semantics). Additional
clients queue in the socket's accept backlog (depth 8) and block until the
running request finishes; beyond that, connect() fails and the CLI falls
back to in-process execution. Trust model: the socket is protected only by
filesystem permissions on its directory (0700 ~/.cache/wgbs_tpu_torch by
default) — do not point WGBS_TPU_WORKER_SOCKET at a world-writable
directory.

Where the port differs from the JAX worker:
- its default socket is its own (~/.cache/wgbs_tpu_torch/worker.sock);
  the environment variables keep their names, so WGBS_TPU_WORKER_SOCKET
  can point both engines' clients at one socket. Each request names its
  engine, and neither server runs the other engine's commands: the port's
  server answers a request without "engine": "torch" (a JAX client's,
  its stop too) with an error and exit code 2, and the port's argv starts
  with ENGINE_TAG, which the JAX CLI refuses as an invalid command (exit
  code 1) before it runs anything. A port stop asks with "halt", which a
  JAX server does not read;
- `serve --warm` runs one small pileup on --device (cuda by default)
  through the default pileup kernel (flat_vals_fused), and a warm-up that
  fails raises: the server exits non-zero rather than serve without the
  kernel;
- after its warm-up and after each request the server prints one line on
  its own stderr, `[wgbs-torch worker serve] launches {...}`: the pileup
  kernels' launches in this process so far (parallel/multihost.py's
  pat2beta launch line).
"""

import argparse
import json
import os
import os.path as op
import socket
import struct
import sys

DEFAULT_SOCKET = op.join(op.expanduser("~"), ".cache", "wgbs_tpu_torch",
                         "worker.sock")


ENGINE = "torch"
# the first word of a request's argv: no command of the JAX CLI, so a JAX
# server on the same socket refuses the request before it runs anything
ENGINE_TAG = "wgbs_tools_tpu_torch-request"


def socket_path():
    return os.environ.get("WGBS_TPU_WORKER_SOCKET", DEFAULT_SOCKET)


class _FrameWriter:
    """File-like that frames writes onto the socket."""

    def __init__(self, sock, kind):
        self.sock = sock
        self.kind = kind

    def write(self, data):
        if isinstance(data, str):
            data = data.encode()
        if data:
            self.sock.sendall(struct.pack("<BI", self.kind, len(data)) + data)
        return len(data)

    def flush(self):
        pass

    @property
    def buffer(self):
        return self

    def isatty(self):
        return False


def _serve_one(conn):
    """Run one request; returns False when the client asked us to stop."""
    buf = b""
    while b"\n" not in buf:
        chunk = conn.recv(65536)
        if not chunk:
            return True
        buf += chunk
    req = json.loads(buf.split(b"\n", 1)[0])
    out = _FrameWriter(conn, 1)
    err = _FrameWriter(conn, 2)
    argv = req.get("argv") or []
    if req.get("engine") != ENGINE or argv[:1] != [ENGINE_TAG]:
        err.write(f"[wgbs-torch worker] refused: this server runs the "
                  f"wgbs_tools_tpu_torch engine, and the request names "
                  f"engine {req.get('engine')!r} (a client of another "
                  f"engine on the same socket); nothing was run\n")
        conn.sendall(struct.pack("<BI", 0, 4) + struct.pack("<i", 2))
        return True
    if req.get("halt"):
        conn.sendall(struct.pack("<BI", 0, 4) + struct.pack("<i", 0))
        return False

    argv = argv[1:]
    old = (sys.stdout, sys.stderr, os.getcwd())
    saved_env = {}
    try:
        if req.get("cwd"):
            os.chdir(req["cwd"])
        client_env = req.get("env") or {}
        # the client's WGBS_* view replaces the server's entirely: a WGBS_*
        # var set in the server's own environment but absent from the
        # client's must not leak into the request
        for k in list(os.environ):
            if (k.startswith("WGBS_") and k not in client_env
                    and k not in ("WGBS_TPU_WORKER", "WGBS_TPU_WORKER_SOCKET")):
                saved_env[k] = os.environ.pop(k)
        for k, v in client_env.items():
            # never apply the routing vars inside the server: a forwarded
            # WGBS_TPU_WORKER=1 would make the worker dial its own socket
            if k in ("WGBS_TPU_WORKER", "WGBS_TPU_WORKER_SOCKET"):
                continue
            saved_env.setdefault(k, os.environ.get(k))
            os.environ[k] = v
        sys.stdout, sys.stderr = out, err
        from .main import main as cli_main

        try:
            rc = cli_main(argv)
        except SystemExit as e:  # argparse exits
            rc = int(e.code or 0)
        except BaseException:
            import traceback

            err.write(traceback.format_exc())
            rc = 1
    finally:
        sys.stdout, sys.stderr = old[0], old[1]
        try:
            os.chdir(old[2])
        except OSError:
            pass
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    conn.sendall(struct.pack("<BI", 0, 4) + struct.pack("<i", int(rc or 0)))
    return True


def _warm_compiles(device="cuda"):
    """One small pileup on `device` through the default pileup kernel
    (flat_vals_fused on cuda), so the first client job starts with the
    CUDA context, the kernels' library and the host library loaded. It
    raises where the device or a kernel fails: there is no fallback."""
    import numpy as np

    from ..formats.pat import PatFrags
    from ..native import pileup_native
    from ..ops.pileup import pileup_frags

    n = 1 << 12
    rng = np.random.default_rng(0)
    start = np.sort(rng.integers(1, n - 20, size=256)).astype(np.int64)
    length = rng.integers(1, 12, size=256).astype(np.int64)
    codes = rng.integers(0, 2, size=(256, 12)).astype(np.uint8)
    codes[np.arange(12)[None, :] >= length[:, None]] = 3
    frags = PatFrags(start, length, np.ones(256, np.int64), codes,
                     np.zeros(256, np.int16), ["chr1"], None)
    got = pileup_frags(frags, (1, n + 1), device=device).cpu().numpy()
    want = pileup_native(start, length, frags.count, codes, 1, n)
    if not np.array_equal(got, want):
        raise RuntimeError("worker: the warm-up pileup differs from the host "
                           "pileup")


def _launch_line():
    """This process's pileup kernel launches, on the server's stderr."""
    import json

    from ..parallel.multihost import _launches

    print(f"[wgbs-torch worker serve] launches "
          f"{json.dumps(_launches('pat2beta'))}", file=sys.stderr, flush=True)


def serve(path=None, warm=False, device="cuda"):
    path = path or socket_path()
    os.makedirs(op.dirname(path), mode=0o700, exist_ok=True)
    if op.exists(path):
        os.unlink(path)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    os.chmod(path, 0o600)  # owner-only even under a permissive umask
    srv.listen(8)  # waiting clients queue here (served one at a time)
    from ..utils import logger

    try:
        if warm:
            logger.info("worker: warming the device pileup on %s...", device)
            _warm_compiles(device)
            _launch_line()
        logger.info("worker: serving on %s (pid %d)", path, os.getpid())
        while True:
            conn, _ = srv.accept()
            try:
                if not _serve_one(conn):
                    break
            except (BrokenPipeError, ConnectionResetError):
                pass  # client went away mid-command; keep serving
            finally:
                conn.close()
            _launch_line()
    finally:
        srv.close()
        try:
            os.unlink(path)
        except OSError:
            pass
    return 0


def run_via_worker(argv, path=None, stop=False):
    """Client: run argv on the worker; returns its rc, or None when no
    worker is reachable (caller falls back to in-process execution)."""
    path = path or socket_path()
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        s.connect(path)
    except OSError:
        s.close()
        return None
    req = {"engine": ENGINE, "argv": [ENGINE_TAG] + list(argv),
           "cwd": os.getcwd(), "halt": stop,
           "env": {k: v for k, v in os.environ.items()
                   if k.startswith("WGBS_")}}
    try:
        s.sendall(json.dumps(req).encode() + b"\n")
        buf = b""
        while True:
            while len(buf) < 5:
                chunk = s.recv(1 << 20)
                if not chunk:
                    return 1  # server died mid-stream
                buf += chunk
            kind, ln = struct.unpack("<BI", buf[:5])
            buf = buf[5:]
            while len(buf) < ln:
                chunk = s.recv(1 << 20)
                if not chunk:
                    return 1
                buf += chunk
            payload, buf = buf[:ln], buf[ln:]
            if kind == 0:
                return struct.unpack("<i", payload)[0]
            stream = sys.stdout if kind == 1 else sys.stderr
            try:
                stream.buffer.write(payload)
                stream.buffer.flush()
            except AttributeError:  # text-only stream (tests)
                stream.write(payload.decode(errors="replace"))
    finally:
        s.close()


def main(argv):
    # NOTE: `run` forwards everything after it verbatim (argparse would
    # swallow the wrapped command's --help), so only serve/stop use argparse
    if argv and argv[0] == "run":
        rest = list(argv[1:])
        path = None
        if rest[:1] == ["--socket"] and len(rest) >= 2:
            path, rest = rest[1], rest[2:]
        rc = run_via_worker(rest, path=path)
        if rc is None:
            print("no worker running; start one with `worker serve`",
                  file=sys.stderr)
            return 1
        return rc
    p = argparse.ArgumentParser(
        prog="worker",
        description="Persistent worker: keep one process (and its CUDA "
        "context and kernels) alive across CLI invocations")
    p.add_argument("verb", choices=["serve", "run", "stop"])
    p.add_argument("--socket", default=None)
    p.add_argument("--warm", action="store_true",
                   help="run the device pileup at startup so the first "
                        "client job runs warm (an error, and a non-zero "
                        "exit, where it fails)")
    p.add_argument("--device", default="cuda",
                   help="the warm-up's torch device: cuda (default; an "
                        "error without CUDA) or cpu")
    args = p.parse_args(argv)
    if args.verb == "serve":
        return serve(args.socket, warm=args.warm, device=args.device)
    rc = run_via_worker([], path=args.socket, stop=True)
    if rc is None:
        print("no worker running", file=sys.stderr)
        return 1
    return rc
