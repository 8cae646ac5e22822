"""Build + run the C++ NerfManagerOnline shim against a live runtime server.

This is the cross-language contract test: the reference-shaped C++ API
(native/include/monerf/nerf_manager.h) drives the JAX runtime over the
socket protocol and gets training + meshes back.
"""

import os
import shutil
import signal
import socket as socket_mod
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(REPO, "native", "build")
SMOKE = os.path.join(BUILD, "manager_smoke")


def _build_native():
    if os.path.exists(SMOKE):
        return
    gen = ["-G", "Ninja"] if shutil.which("ninja") else []
    subprocess.run(
        ["cmake", "-S", os.path.join(REPO, "native"), "-B", BUILD, *gen],
        check=True, capture_output=True,
    )
    subprocess.run(["cmake", "--build", BUILD], check=True, capture_output=True)


@pytest.mark.skipif(shutil.which("cmake") is None, reason="no cmake")
def test_cpp_manager_smoke(tmp_path):
    _build_native()
    sock = str(tmp_path / "monerf.sock")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    server = subprocess.Popen(
        [sys.executable, "-m", "romap_tpu.runtime.server", "--socket", sock,
         "--small", "--platform", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        for _ in range(120):
            if os.path.exists(sock):
                break
            if server.poll() is not None:
                raise RuntimeError(f"server died: {server.stdout.read()}")
            time.sleep(0.5)
        else:
            raise TimeoutError("server socket never appeared")

        out = subprocess.run([SMOKE, sock], capture_output=True, text=True,
                             timeout=420)
        assert out.returncode == 0, f"stdout={out.stdout} stderr={out.stderr}"
        assert out.stdout.startswith("OK"), out.stdout
    finally:
        server.send_signal(signal.SIGTERM)
        try:
            server.wait(timeout=10)
        except subprocess.TimeoutExpired:
            server.kill()


def test_watchdog_stall_detection(monkeypatch):
    """The device-stall watchdog flags an op stuck past its threshold,
    re-warns once per further threshold, and stays silent otherwise."""
    monkeypatch.setenv("ROMAP_WATCHDOG_S", "10")
    from romap_tpu.runtime.server import OPS, RuntimeServer

    srv = RuntimeServer.__new__(RuntimeServer)
    srv._running = True
    srv._watchdog_s = 10.0
    srv._watchdog_fatal = False
    srv._inflight = None
    srv._warned_at = 0.0

    assert srv._watchdog_check(100.0) is None  # idle
    srv._inflight = (OPS["WAIT_END"], 100.0)
    assert srv._watchdog_check(105.0) is None  # under threshold
    msg = srv._watchdog_check(111.0)
    assert msg is not None and "WAIT_END" in msg and "11s" in msg
    assert srv._watchdog_check(115.0) is None  # already warned this window
    msg2 = srv._watchdog_check(122.0)  # next threshold crossing
    assert msg2 is not None
    srv._inflight = None
    assert srv._watchdog_check(200.0) is None  # op completed


@pytest.mark.parametrize("platform,ok", [("gpu", True), ("cpu", True),
                                         ("tpu", False)])
def test_server_platform_choices(platform, ok):
    """--platform takes gpu or cpu; any other value is refused."""
    from romap_tpu.runtime.server import build_parser

    argv = ["--socket", "/nonexistent.sock", "--platform", platform]
    if ok:
        assert build_parser().parse_args(argv).platform == platform
    else:
        with pytest.raises(SystemExit):
            build_parser().parse_args(argv)
