"""The port's persistent worker (cli/worker.py) on the CPU: `worker serve`
answers `worker run` and WGBS_TPU_WORKER=1 requests with the output, the
exit code and the files of the same command run in its own process;
`worker stop` ends it. A server refuses the other engine's requests on
a shared socket, and the other engine's server refuses the port's, each
running nothing. Without a server, `worker run` says so as the JAX
worker does, and WGBS_TPU_WORKER=1 runs the command in-process. A
`serve --warm` whose warm-up fails (CUDA missing) raises and leaves no
socket; on the CPU the warm-up's pileup runs and the server serves.

The socket lives under a short directory in /tmp (AF_UNIX paths stop at
108 bytes), and the tests wait up to 120 s for the server's socket."""

import os
import os.path as op
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synth import random_frags  # noqa: E402
from wgbs_tools_tpu.formats.pat import write_pat  # noqa: E402

REPO = op.dirname(op.dirname(op.abspath(__file__)))
DEADLINE = 120.0


def _wait_for(path, proc=None):
    t0 = time.monotonic()
    while not op.exists(path):
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(proc.communicate()[0].decode()[-3000:])
        if time.monotonic() - t0 > DEADLINE:
            raise RuntimeError(f"the worker's socket {path} never appeared")
        time.sleep(0.1)


@pytest.fixture()
def sock_dir():
    d = tempfile.mkdtemp(prefix="wt", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture()
def pat(mini_genome, tmp_path):
    frags = random_frags(np.random.default_rng(21), 600,
                         mini_genome.get_nr_sites(), max_len=10)
    path = str(tmp_path / "w.pat.gz")
    write_pat(frags.sort().collapse(), path)
    return path


def _env(sock, **kw):
    env = dict(os.environ, PYTHONPATH=REPO, WGBS_TPU_WORKER_SOCKET=sock)
    env.pop("WGBS_TPU_WORKER", None)
    env.update(kw)
    return env


def _cli(args, env, cwd):
    return subprocess.run([sys.executable, "-m", "wgbs_tools_tpu_torch"]
                          + args, env=env, cwd=cwd, capture_output=True,
                          timeout=300)


def test_worker_serves_commands_as_in_process(pat, sock_dir, tmp_path):
    sock = op.join(sock_dir, "w.sock")
    env = _env(sock)
    server = subprocess.Popen(
        [sys.executable, "-m", "wgbs_tools_tpu_torch", "worker", "serve"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        _wait_for(sock, server)
        dirs = {}
        for who in ("worker", "routed", "direct"):
            d = tmp_path / who
            d.mkdir()
            dirs[who] = d
        runs = {}
        for args in (["pat2beta", pat, "-o", ".", "--device", "cpu"],
                     ["frag_len", pat, "-v"],
                     ["beta_stats", "w.beta"],
                     ["frag_len", "/nonexistent.pat.gz"]):
            runs[args[0] + str(len(runs))] = (
                _cli(["worker", "run"] + args, env, dirs["worker"]),
                _cli(args, dict(env, WGBS_TPU_WORKER="1"), dirs["routed"]),
                _cli(args, env, dirs["direct"]))
        for name, (w, r, d) in runs.items():
            assert w.returncode == r.returncode == d.returncode, name
            assert w.stdout == r.stdout == d.stdout, name
        assert runs["frag_len3"][2].returncode != 0
        assert runs["frag_len1"][2].stdout.count(b"\n") > 3
        assert runs["beta_stats2"][2].stdout.count(b"\n") == 2
        for who in ("worker", "routed"):
            assert (dirs[who] / "w.beta").read_bytes() == \
                (dirs["direct"] / "w.beta").read_bytes()
        stop = _cli(["worker", "stop"], env, tmp_path)
        assert stop.returncode == 0
        assert server.wait(timeout=60) == 0
        log = server.stdout.read().decode()
        assert "serving on" in log
        assert log.count("[wgbs-torch worker serve] launches") == 8
        assert not op.exists(sock)
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()


def _serve(package, env):
    return subprocess.Popen(
        [sys.executable, "-m", package, "worker", "serve"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _run(package, args, env, cwd):
    return subprocess.run([sys.executable, "-m", package] + args, env=env,
                          cwd=cwd, capture_output=True, timeout=300)


@pytest.mark.parametrize("server,client", [
    ("wgbs_tools_tpu", "wgbs_tools_tpu_torch"),
    ("wgbs_tools_tpu_torch", "wgbs_tools_tpu")])
def test_worker_refuses_the_other_engine(server, client, pat, sock_dir,
                                         tmp_path):
    """One socket, a server of one engine and clients of the other: every
    request is refused with nothing run (no output file, no stdout), and
    the other engine's stop leaves the server serving; its own stop ends
    it."""
    sock = op.join(sock_dir, "w.sock")
    env = _env(sock, JAX_PLATFORMS="cpu")
    proc = _serve(server, env)
    try:
        _wait_for(sock, proc)
        runs = [_run(client, ["worker", "run", "pat2beta", pat, "-o", "."]
                     + (["--device", "cpu"] if client.endswith("torch")
                        else []), env, tmp_path),
                _run(client, ["frag_len", pat, "-v"],
                     dict(env, WGBS_TPU_WORKER="1"), tmp_path)]
        refusal = (b"Invalid command: wgbs_tools_tpu_torch-request"
                   if server == "wgbs_tools_tpu" else
                   b"[wgbs-torch worker] refused")
        for r in runs:
            assert r.returncode == (1 if server == "wgbs_tools_tpu" else 2)
            assert r.stdout == b"" and refusal in r.stderr
        assert not op.exists(tmp_path / "w.beta")
        _run(client, ["worker", "stop"], env, tmp_path)
        time.sleep(0.5)
        assert proc.poll() is None and op.exists(sock)
        assert _run(server, ["worker", "stop"], env, tmp_path).returncode == 0
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_worker_without_server(pat, sock_dir, tmp_path):
    env = _env(op.join(sock_dir, "missing.sock"))
    r = _cli(["worker", "run", "frag_len", pat], env, tmp_path)
    assert r.returncode == 1 and b"no worker running" in r.stderr
    routed = _cli(["frag_len", pat, "-v"], dict(env, WGBS_TPU_WORKER="1"),
                  tmp_path)
    direct = _cli(["frag_len", pat, "-v"], env, tmp_path)
    assert routed.returncode == direct.returncode == 0
    assert routed.stdout == direct.stdout and routed.stdout
    stop = _cli(["worker", "stop"], env, tmp_path)
    assert stop.returncode == 1 and b"no worker running" in stop.stderr


def test_worker_warm_failure_exits_nonzero(sock_dir, monkeypatch):
    from wgbs_tools_tpu_torch.cli import worker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sock = op.join(sock_dir, "w.sock")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        worker.main(["serve", "--warm", "--socket", sock])
    assert not op.exists(sock)
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["worker", "serve", "--warm", "--socket", sock])
    assert not op.exists(sock)


def test_worker_warm_on_cpu_serves(sock_dir, capsys):
    from wgbs_tools_tpu_torch.cli import worker

    sock = op.join(sock_dir, "w.sock")
    rcs = []
    t = threading.Thread(target=lambda: rcs.append(
        worker.serve(sock, warm=True, device="cpu")), daemon=True)
    t.start()
    _wait_for(sock)
    assert worker.run_via_worker([], path=sock, stop=True) == 0
    t.join(timeout=60)
    assert rcs == [0] and not op.exists(sock)
    assert "[wgbs-torch worker serve] launches" in capsys.readouterr().err
