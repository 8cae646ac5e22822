"""chip_smoke.py: refuses to run without a GPU, and its phases, driven here
at tiny sizes on the CPU. The tests marked `gpu` run the phases at full
width on the card:
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_chip_smoke.py`."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _tiny_cfg():
    from romap_tpu.config import EncodingConfig, NerfConfig, TrainConfig

    return NerfConfig(
        encoding=EncodingConfig(kind="mxgrid", mx_levels=3,
                                mx_max_resolution=64, mx_features=16,
                                mx_plane_res=32, mx_plane_features=8),
        train=TrainConfig(rays_per_batch=512, samples_per_ray=16,
                          mc_resolution=17),
    )


def test_chip_smoke_without_gpu_fails_and_prints_no_ok_line():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_compare_steps_counts_adam_sign_flips():
    lr = chip_smoke.LR
    p0 = {"table": np.zeros(8, np.float32), "mlp": np.zeros(2, np.float32)}
    step = {"table": -lr * np.ones(8, np.float32), "mlp": lr * np.ones(2, np.float32)}
    other = {"table": step["table"].copy(), "mlp": step["mlp"] + 1e-6}
    other["table"][:2] *= -1  # two entries stepped the other way
    r = chip_smoke.compare_steps(p0, step, other, np.array([1.0]),
                                 np.array([1.0 + 1e-5]))
    assert r["flip_frac"] == pytest.approx(0.2)
    assert r["flip_frac_table"] == pytest.approx(0.25)
    assert r["flip_frac_mlp"] == 0.0
    assert r["nonflip_max_abs"] == pytest.approx(1e-6, rel=1e-2)
    assert r["loss_rel"] == pytest.approx(1e-5, rel=1e-3)


def test_trainer_phase_times_and_traces_a_wave(tmp_path):
    """Flagship widths, one object, short waves: compile, timed waves,
    falling losses, and a traced wave reduced to per-scope kernel time."""
    res = chip_smoke.phase_trainer("cpu", str(tmp_path / "cache"),
                                   str(tmp_path), n_objects=1, n_frames=4,
                                   res=32, wave_iters=10, n_waves=1)
    assert res["rate"] > 0 and 0 < res["encode_share"] < 1
    st = json.load(open(tmp_path / "trainer_trace.json"))
    assert st["kernel_ns"]["encode"] > 0 and st["kernel_ns"]["mlp"] > 0


def test_server_phase_drives_the_socket_protocol(tmp_path):
    chip_smoke.phase_server(str(tmp_path), cfg=_tiny_cfg(), capacity=8,
                            n_frames=14, res=64, train_iters=250)
    assert not os.path.exists(tmp_path / "server.sock")


def test_offline_phase_writes_the_artifact_tree(tmp_path):
    chip_smoke.phase_offline(
        str(tmp_path), res=48, steps=20,
        extra_args=("--rays", "256", "--samples", "8", "--mc-res", "17",
                    "--mx-features", "16", "--mx-max-res", "64"))
    assert os.path.exists(tmp_path / "offline_out" / "0" / "obj.ply")


# ---- on the card: the phases at full width --------------------------------


@pytest.mark.gpu
def test_trainer_full_width_on_gpu(gpu, tmp_path):
    from romap_tpu.utils import jax_env

    res = chip_smoke.phase_trainer("gpu", jax_env.setup_compile_cache(),
                                   str(tmp_path), n_waves=2)
    assert res["rate"] > 0 and 0 < res["encode_share"] <= 1
    json.load(open(tmp_path / "trainer_trace.json"))


@pytest.mark.gpu
def test_reference_comparisons_on_gpu(gpu):
    chip_smoke.phase_reference(None)


@pytest.mark.gpu
def test_server_phase_on_gpu(gpu, tmp_path):
    chip_smoke.phase_server(str(tmp_path))


@pytest.mark.gpu
def test_offline_phase_on_gpu(gpu, tmp_path):
    chip_smoke.phase_offline(str(tmp_path))


@pytest.mark.gpu
def test_sharded_table_on_all_gpus(gpu):
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs several GPUs")
    chip_smoke.phase_cards(len(jax.devices()), "gpu",
                           capacity=4 * len(jax.devices()))
