"""Smoke run of the system's main path on one GPU, or of the object-sharded
table on four.

    python chip_smoke.py                 # one card, five phases
    python chip_smoke.py --cards 4       # four cards: the sharded table only
    python chip_smoke.py --out DIR       # also write trace summaries to DIR

One card, in one process (a JAX process reserves most of a card's memory,
so a second one would fail):
  1. device     the card, its power limit, JAX versions, compile cache
  2. trainer    flagship NerfConfig(), 10 objects through nerf.train_objects:
                cold/warm compile, steady obj-iters/s, encode share of the
                step from a profiler trace, falling finite losses
  3. reference  (a) fp32 "highest" step vs the same step on the CPU,
                (b) the bf16 step vs (a)'s fp32 step, (c) mxgrid.encode and
                render_rays in fp32 at default precision vs the CPU
  4. server     RuntimeServer on a thread, driven over its UNIX socket
  5. offline    romap_tpu.runtime.offline on a written room dataset

With --cards 4: NerfManagerOnline at flagship width (capacity 16, 10
objects) on a mesh over four cards against the same wave on one card.

Exits non-zero, with no ok line, when JAX finds no GPU or a phase fails.
The last line of stdout is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# phase 3 compares against the CPU backend, which must stay available next
# to the GPU when JAX_PLATFORMS names the GPU alone
_plat = os.environ.get("JAX_PLATFORMS")
if _plat and "cpu" not in _plat.split(","):
    os.environ["JAX_PLATFORMS"] = _plat + ",cpu"

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

LR = 1e-2  # OptimizerConfig.learning_rate: Adam's first step moves each entry by ~LR


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseError(AssertionError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseError(msg)


def nvidia_smi_cards() -> list[str]:
    """One "name, power.limit" line per card, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()


def flagship(compute_dtype: str = "auto"):
    from romap_tpu.config import NerfConfig
    from romap_tpu.models import nerf

    cfg = NerfConfig()
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, compute_dtype=compute_dtype))
    return cfg, nerf.make_field_spec(cfg)


def to_np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(a, np.float32).ravel()
                           for a in jax.tree.leaves(tree)])


def compare_steps(p0, pa, pb, la, lb) -> dict:
    """One Adam step from p0 gives pa / pb and per-object losses la / lb.
    Adam's first update is LR * sign(grad), so an entry whose gradient sign
    differs moves 2 LR apart: count those as flips, and bound the rest."""
    da, db = flat(pa) - flat(p0), flat(pb) - flat(p0)
    diff = np.abs(da - db)
    flip = diff > 0.5 * LR
    out = {
        "loss_rel": float(np.max(np.abs(la - lb) / np.maximum(np.abs(lb), 1e-12))),
        "flip_frac": float(flip.mean()),
        "nonflip_max_abs": float(diff[~flip].max()) if (~flip).any() else 0.0,
    }
    for k in p0:  # per parameter group ("table", "mlp")
        dk = np.abs((flat(pa[k]) - flat(p0[k])) - (flat(pb[k]) - flat(p0[k])))
        out[f"flip_frac_{k}"] = float((dk > 0.5 * LR).mean())
    return out


# --------------------------------------------------------------------------
# phase 1: device
# --------------------------------------------------------------------------


def phase_device(cache_dir: str) -> dict:
    import jaxlib

    dev = jax.devices()[0]
    cards = nvidia_smi_cards()
    log(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())}")
    for line in cards:
        log(line)
    # the label put beside every number: one line, or each distinct one
    card = "; ".join(dict.fromkeys(cards))
    log(f"jax {jax.__version__} jaxlib {jaxlib.__version__}; "
        f"compile cache {cache_dir}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card}


# --------------------------------------------------------------------------
# phase 2: trainer at full width
# --------------------------------------------------------------------------


def _cache_entries(cache_dir: str) -> int:
    return len(glob.glob(os.path.join(cache_dir, "*")))


def phase_trainer(card: str, cache_dir: str, out_dir: str | None,
                  n_objects: int = 10, n_frames: int = 48, res: int = 480,
                  wave_iters: int = 20, n_waves: int = 5) -> dict:
    from romap_tpu.data.world import build_synthetic_world
    from romap_tpu.models import nerf
    from romap_tpu.utils import profiling

    cfg, spec = flagship()
    t0 = time.perf_counter()
    _, _, _, store, objs = build_synthetic_world(
        n_objects=n_objects, n_frames=n_frames, res=res)
    frames = store.arrays()
    check(bool(np.all(np.asarray(objs.active))), "an object has no bboxes")
    log(f"trainer: world {n_objects} objects x {n_frames} frames at {res}, "
        f"{sum(a.nbytes for a in frames) / 1e6:.1f} MB frame store, "
        f"built in {time.perf_counter() - t0:.1f} s")
    state = nerf.init_train_state(
        jax.random.PRNGKey(cfg.seed), n_objects, cfg, spec)

    args = (state, objs, frames, cfg, spec, wave_iters)
    before = _cache_entries(cache_dir)
    t0 = time.perf_counter()
    lowered = nerf.train_objects.lower(*args)
    t_lower = time.perf_counter() - t0
    t0 = time.perf_counter()
    compiled = lowered.compile()
    t_cold = time.perf_counter() - t0
    jax.clear_caches()
    t0 = time.perf_counter()
    nerf.train_objects.lower(*args).compile()
    t_warm = time.perf_counter() - t0
    log(f"trainer: compile cold {t_cold:.2f} s (lowering {t_lower:.2f} s, "
        f"cache entries {before} -> {_cache_entries(cache_dir)}), "
        f"warm from the persistent cache {t_warm:.2f} s")

    t0 = time.perf_counter()
    state = jax.block_until_ready(compiled(state, objs, frames))
    t_first = time.perf_counter() - t0
    first = np.asarray(state.loss)
    check(np.isfinite(first).all(), f"non-finite first-wave loss {first}")
    times = []
    for _ in range(n_waves):
        t0 = time.perf_counter()
        state = jax.block_until_ready(compiled(state, objs, frames))
        times.append(time.perf_counter() - t0)
    last = np.asarray(state.loss)
    check(np.isfinite(last).all(), f"non-finite loss {last}")
    check(bool(np.all(last < first)),
          f"losses did not fall: first wave {first}, last wave {last}")
    rate = n_objects * wave_iters / float(np.median(times))
    log(f"trainer: first wave {t_first:.3f} s; wave times "
        f"{[round(t, 4) for t in times]} s; {rate:.2f} obj-iters/s "
        f"({n_objects} objects, {cfg.train.rays_per_batch} rays x "
        f"{cfg.train.samples_per_ray} samples, median of {n_waves} waves of "
        f"{wave_iters}) on {card}")
    log(f"trainer: loss first wave {np.round(first, 5).tolist()} -> last "
        f"{np.round(last, 5).tolist()}")

    # Inside a CUDA graph the profiler names every kernel "command_buffer",
    # so the traced wave runs an executable built without command buffers;
    # its wave time is printed beside the graphed one.
    plain = nerf.train_objects.lower(
        state, objs, frames, cfg, spec, wave_iters).compile(
            compiler_options={"xla_gpu_enable_command_buffer": ""})
    state = jax.block_until_ready(plain(state, objs, frames))
    t0 = time.perf_counter()
    state = jax.block_until_ready(plain(state, objs, frames))
    t_plain = time.perf_counter() - t0
    trace_dir = tempfile.mkdtemp(prefix="romap_trace_")
    try:
        with jax.profiler.trace(trace_dir):
            state = jax.block_until_ready(plain(state, objs, frames))
        xplane = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                           recursive=True)
        check(len(xplane) == 1, f"expected one trace file, found {xplane}")
        st = profiling.scope_times(
            xplane[0], [plain.as_text()],
            plane_prefix="/host:CPU" if jax.default_backend() == "cpu"
            else "/device:GPU")
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    ker = st["kernel_ns"]
    total = max(st["total_kernel_ns"], 1)
    enc_ms = ker["encode"] / 1e6 / wave_iters
    log(f"trainer: wave without command buffers {t_plain:.4f} s "
        f"({n_objects * wave_iters / t_plain:.2f} obj-iters/s); traced "
        f"wave: {st['n_events']} kernels, encode fwd+bwd "
        f"{enc_ms:.3f} ms/iter = {ker['encode'] / total:.3f} of kernel time, "
        f"mlp {ker['mlp'] / total:.3f}, other {ker['other'] / total:.3f}; "
        f"kernel time {total / 1e6 / wave_iters:.3f} ms/iter, idle share "
        f"{1 - st['busy_ns'] / max(st['window_ns'], 1):.3f} on {card}")
    check(ker["encode"] > 0, "trace attributed no kernel time to encode")
    if out_dir:
        with open(os.path.join(out_dir, "trainer_trace.json"), "w") as f:
            json.dump(st, f, indent=1)
        with open(os.path.join(out_dir, "trainer_hlo.txt"), "w") as f:
            f.write(plain.as_text())
    return {"state": state, "objs": objs, "rate": rate,
            "encode_share": ker["encode"] / total}


# --------------------------------------------------------------------------
# phase 3: reference comparisons
# --------------------------------------------------------------------------


def _train_one_step(state, objs, frames, cfg, spec, device):
    from romap_tpu.models import nerf

    put = lambda t: jax.device_put(t, device)
    out = nerf.train_objects(put(state), put(objs), put(frames), cfg, spec, 1)
    return to_np(out.params), np.asarray(out.loss)


def phase_reference(trained: dict | None = None, n_objects: int = 2,
                    n_frames: int = 16, res: int = 480) -> None:
    from romap_tpu.data.world import build_synthetic_world
    from romap_tpu.models import nerf
    from romap_tpu.ops import mxgrid
    from romap_tpu.ops.geometry import camera_rays, ray_aabb_intersect
    from romap_tpu.runtime.renderer import orbit_poses

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    cfg32, spec = flagship("float32")
    cfg16, _ = flagship("bfloat16")
    cam, _, _, store, objs = build_synthetic_world(
        n_objects=n_objects, n_frames=n_frames, res=res)
    frames = to_np(store.arrays())
    objs = to_np(objs)
    state0 = to_np(nerf.init_train_state(
        jax.random.PRNGKey(cfg32.seed), n_objects, cfg32, spec))
    p0 = state0.params

    # (a) fp32 "highest" on the card vs the CPU
    with jax.default_matmul_precision("highest"):
        p_g, l_g = _train_one_step(state0, objs, frames, cfg32, spec, gpu)
        p_c, l_c = _train_one_step(state0, objs, frames, cfg32, spec, cpu)
    a = compare_steps(p0, p_g, p_c, l_g, l_c)
    tol_a = {"loss_rel": 1e-3, "flip_frac": 1e-3, "nonflip_max_abs": 1e-2 * LR}
    log(f"reference (a): one train_objects step, float32, matmul precision "
        f"highest, GPU vs CPU ({n_objects} objects, flagship widths): {a}; "
        f"tolerance {tol_a} (summation order only)")
    for k, v in tol_a.items():
        check(a[k] <= v, f"(a) {k} {a[k]} > {v}")

    # (b) the bf16 step vs (a)'s fp32 step, both on the card
    p_b, l_b = _train_one_step(state0, objs, frames, cfg16, spec, gpu)
    b = compare_steps(p0, p_b, p_g, l_b, l_g)
    tol_b = {"loss_rel": 1e-2, "flip_frac": 0.15}
    log(f"reference (b): one step, compute bfloat16 (MX-grid contract: fp32 "
        f"points/bases/accumulation, bf16 matmul operands) vs float32 "
        f"highest, both GPU: {b}; tolerance {tol_b} (bf16 operand rounding "
        f"2^-9, the encode within ~0.5% of fp32; Adam's first step is "
        f"sign(grad), so entries whose gradient is within bf16 rounding of "
        f"zero flip, where an unrelated gradient flips half)")
    for k, v in tol_b.items():
        check(b[k] <= v, f"(b) {k} {b[k]} > {v}")

    # (c) fp32 at default precision (TF32 on the card) vs the CPU: the
    # encode, then the whole field; then render_rays as shipped, whose
    # fp32 inference runs its matmuls at "highest" (nerf.field_apply)
    params = (jax.tree.map(lambda x: np.asarray(x[0]), to_np(trained["state"].ema))
              if trained else jax.tree.map(lambda x: x[0], p0))
    pts = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (65536, 3)))
    table = params["table"]
    enc = lambda dev: np.asarray(jax.jit(
        lambda t, p: mxgrid.encode(t, p, spec))(jax.device_put(table, dev),
                                                 jax.device_put(pts, dev)))
    e_g, e_c = enc(gpu), enc(cpu)
    enc_rel = float(np.linalg.norm(e_g - e_c) / np.linalg.norm(e_c))
    log(f"reference (c): mxgrid.encode float32, default matmul precision "
        f"(TF32 on the card), GPU vs CPU, 65536 points: rel L2 {enc_rel:.3e}; "
        f"tolerance 1e-2 (TF32 keeps 10 mantissa bits)")
    check(enc_rel <= 1e-2, f"(c) encode rel L2 {enc_rel}")
    field = lambda dev: np.asarray(jax.jit(
        lambda q, x: nerf.field_apply(q, x, cfg32, spec))(
            jax.device_put(params, dev), jax.device_put(pts, dev)))
    f_g, f_c = field(gpu), field(cpu)
    log(f"reference (c): field_apply float32, default matmul precision, GPU "
        f"vs CPU, 65536 points: max |d log-density| "
        f"{np.abs(f_g[:, 3] - f_c[:, 3]).max():.3e}, max |d rgb logit| "
        f"{np.abs(f_g[:, :3] - f_c[:, :3]).max():.3e} (features up to "
        f"{np.abs(e_c).max():.3e}, log-density up to "
        f"{np.abs(f_c[:, 3]).max():.3e}); reported, not checked")

    # object-centric view of object 0, as the 360 video renders it
    objs_src = trained["objs"] if trained else objs
    aabb_min = np.asarray(objs_src.aabb_min)[0]
    aabb_max = np.asarray(objs_src.aabb_max)[0]
    toc = orbit_poses(1, 30.0, 4.0 * float(np.max(aabb_max)))[0]
    ys, xs = np.mgrid[0:res:2, 0:res:2]
    o, d, dn = camera_rays(jnp.asarray(xs.ravel(), jnp.float32),
                           jnp.asarray(ys.ravel(), jnp.float32),
                           jnp.asarray(cam.intrinsics), jnp.asarray(toc),
                           jnp.eye(4, dtype=jnp.float32))
    tmin, tmax, hit = ray_aabb_intersect(o, d, jnp.asarray(aabb_min),
                                         jnp.asarray(aabb_max))
    tmin = jnp.maximum(tmin, 0.0)
    jitter = jax.random.uniform(jax.random.PRNGKey(4), (o.shape[0], 64))
    ray_args = to_np((o, d, dn, tmin, tmax, hit, jitter, aabb_min, aabb_max))

    def render(dev):
        args = jax.device_put((params,) + tuple(ray_args), dev)
        return [np.asarray(x) for x in
                nerf.render_rays(*args, cfg32, spec, n_samples=64)]

    (rgb_g, dep_g, msk_g), (rgb_c, dep_c, msk_c) = render(gpu), render(cpu)
    sel = np.asarray(ray_args[5]).astype(bool)
    r = {
        "rays_in_box": int(sel.sum()),
        "rgb_max_abs": float(np.abs(rgb_g - rgb_c).max()),
        "mask_max_abs": float(np.abs(msk_g - msk_c).max()),
        "depth_max_rel": float((np.abs(dep_g - dep_c)
                                / np.maximum(np.abs(dep_c), 1e-3))[sel].max()
                               if sel.any() else 0.0),
    }
    tol_r = {"rgb_max_abs": 1.0 / 255, "mask_max_abs": 1.0 / 255,
             "depth_max_rel": 1e-2}
    log(f"reference (c): render_rays float32 (matmul precision highest), "
        f"64 samples, GPU vs CPU over "
        f"{len(sel)} rays: {r}; tolerance {tol_r} (one 8-bit step of the "
        f"written PNG for rgb and mask)")
    check(r["rays_in_box"] > 0, "(c) no ray hit the object box")
    for k, v in tol_r.items():
        check(r[k] <= v, f"(c) {k} {r[k]} > {v}")


# --------------------------------------------------------------------------
# phase 4: the served online path
# --------------------------------------------------------------------------


class Client:
    """Minimal client of runtime/server.py's length-prefixed protocol."""

    def __init__(self, path: str):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.connect(path)

    def call(self, op: int, payload: bytes = b"") -> bytes:
        self.sock.sendall(struct.pack("<II", op, len(payload)) + payload)
        status, n = struct.unpack("<II", self._recv(8))
        reply = self._recv(n) if n else b""
        check(status == 0, f"opcode {op} failed: {reply.decode(errors='replace')}")
        return reply

    def _recv(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed the socket")
            buf.extend(chunk)
        return bytes(buf)

    def close(self) -> None:
        self.sock.close()


def _str(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<H", len(b)) + b


def phase_server(work: str, cfg=None, capacity: int = 16, n_frames: int = 24,
                 res: int = 480, n_objects: int = 4, train_iters: int = 250,
                 waves: int = 2) -> None:
    from romap_tpu.data.synthetic import Camera, make_scene, make_sequence
    from romap_tpu.runtime.server import OPS, RuntimeServer
    from romap_tpu.utils.png import read_png

    cam = Camera(fx=res * 0.9, fy=res * 0.9, cx=res / 2, cy=res / 2, h=res, w=res)
    objects = make_scene(n_objects, seed=0)
    seq = make_sequence(cam, objects, n_frames, radius=5.5, seed=0)
    sock_path = os.path.join(work, "server.sock")
    server = RuntimeServer(cfg)
    th = threading.Thread(target=server.serve, args=(sock_path,), daemon=True)
    th.start()
    for _ in range(600):
        if os.path.exists(sock_path):
            break
        time.sleep(0.1)
    c = Client(sock_path)
    t0 = time.perf_counter()
    try:
        c.call(OPS["INIT"], struct.pack("<BiiB", 0, train_iters, capacity, 1))
        c.call(OPS["DATASET_INIT"], struct.pack(
            "<ffffiii", cam.fx, cam.fy, cam.cx, cam.cy, res, res, 48))
        for fi, fr in enumerate(seq):
            c.call(OPS["NEW_FRAME"], struct.pack("<i", fi) + _str(fr["stamp"])
                   + b"\x00" + fr["rgb"].astype(np.uint8).tobytes()
                   + fr["instance"].astype(np.uint8).tobytes()
                   + np.asarray(fr["twc"], np.float32).tobytes())
        for o in objects:
            tow = np.eye(4, dtype=np.float32)
            tow[:3, 3] = -o.center
            half = o.aabb_half_extents()
            rep = c.call(OPS["CREATE_NERF"], struct.pack("<i", int(o.instance_id))
                         + tow.tobytes() + (-half).astype(np.float32).tobytes()
                         + half.astype(np.float32).tobytes())
            idx = struct.unpack("<i", rep[:4])[0]
            rows = np.array([(fi, *fr["bboxes"][o.instance_id])
                             for fi, fr in enumerate(seq)
                             if fr["bboxes"][o.instance_id] is not None], np.int32)
            check(len(rows) > 10, f"object {idx}: {len(rows)} bboxes, need > 10")
            c.call(OPS["UPDATE_BBOX"], struct.pack("<iii", idx, waves, len(rows))
                   + rows.tobytes())
        t_setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        ran = struct.unpack("<i", c.call(OPS["PUMP"], struct.pack("<i", -1)))[0]
        t_pump = time.perf_counter() - t0
        check(ran == waves, f"PUMP ran {ran} waves, expected {waves}")
        rep = c.call(OPS["GET_LOSSES"])
        n = struct.unpack("<i", rep[:4])[0]
        losses = np.frombuffer(rep[4:], np.float32, n)
        check(n == n_objects and np.isfinite(losses).all() and (losses > 0).all(),
              f"losses {losses}")
        rep = c.call(OPS["GET_MESH"], struct.pack("<i", 0))
        nv, nf = struct.unpack("<ii", rep[:8])
        check(nv > 0 and nf > 0, f"empty mesh for object 0 ({nv} verts, {nf} faces)")
        fr = seq[n_frames // 2]
        box = fr["bboxes"][objects[0].instance_id]
        out = os.path.join(work, "render")
        c.call(OPS["RENDER_TEST"], struct.pack("<ifB", 0, 3.0, 0) + _str(out)
               + struct.pack("<i", 1) + _str(fr["stamp"])
               + np.asarray(box, np.int32).tobytes()
               + np.asarray(fr["twc"], np.float32).tobytes() + b"\x00")
        pngs = sorted(glob.glob(os.path.join(out, "0", "test_*", "*.png")))
        check(len(pngs) == 3, f"expected 3 test PNGs, found {pngs}")
        img = read_png(os.path.join(out, "0", "test_img", f"{fr['stamp']}.png"))
        check(img.shape == (box[2], box[3], 3), f"render shape {img.shape}")
        c.call(OPS["SHUTDOWN"])
    finally:
        c.close()
    th.join(timeout=60)
    check(not th.is_alive(), "server thread did not stop")
    log(f"server: {n_frames} frames at {res}x{res}, {n_objects} objects "
        f"(capacity {capacity}), setup {t_setup:.1f} s, PUMP {waves} waves x "
        f"{train_iters} iters in {t_pump:.1f} s (compile included); losses "
        f"{np.round(losses, 5).tolist()}; mesh {nv} verts / {nf} faces; "
        f"{len(pngs)} PNGs")


# --------------------------------------------------------------------------
# phase 5: offline runner
# --------------------------------------------------------------------------


def phase_offline(work: str, res: int = 480, steps: int = 100,
                  extra_args: tuple[str, ...] = ()) -> None:
    from romap_tpu.data.world import write_room_dataset
    from romap_tpu.runtime import offline

    data = os.path.join(work, "room")
    out = os.path.join(work, "offline_out")
    t0 = time.perf_counter()
    write_room_dataset(data, n_objects=1, res=res)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    offline.main(["-", data, "0", "--waves", "1", "--steps-per-wave",
                  str(steps), "--out", out, *extra_args])
    t_run = time.perf_counter() - t0
    base = os.path.join(out, "0")
    for sub in ("test_img", "test_depth", "test_mask", "video_img", "video_depth"):
        check(len(glob.glob(os.path.join(base, sub, "*.png"))) > 0,
              f"offline artifact tree: no PNG in {sub}")
    for name in ("test.txt", "train.txt", "obj.ply"):
        check(os.path.getsize(os.path.join(base, name)) > 0,
              f"offline artifact tree: empty {name}")
    check(os.path.exists(os.path.join(out, "0.ply")), "no 0.ply mesh")
    log(f"offline: room dataset at {res} written in {t_data:.1f} s; one wave "
        f"of {steps} steps with artifacts in {t_run:.1f} s; artifact tree ok")


# --------------------------------------------------------------------------
# four cards: the object-sharded table
# --------------------------------------------------------------------------


def _manager_wave(mesh, cfg, seq, cam, objects, capacity: int, iters: int):
    from romap_tpu.runtime.manager import NerfManagerOnline

    mgr = NerfManagerOnline(cfg, train_step_iterations=iters, capacity=capacity,
                            mesh_enabled=False, mesh=mesh)
    mgr.dataset_init(cam.fx, cam.fy, cam.cx, cam.cy, cam.h, cam.w, len(seq))
    for fi, fr in enumerate(seq):
        mgr.new_frame_to_dataset(fi, fr["stamp"], fr["rgb"], fr["instance"],
                                 pose=fr["twc"])
    for o in objects:
        tow = np.eye(4, dtype=np.float32)
        tow[:3, 3] = -o.center
        half = o.aabb_half_extents()
        idx = mgr.create_nerf(int(o.instance_id), tow, -half, half)
        rows = [(fi, *fr["bboxes"][o.instance_id]) for fi, fr in enumerate(seq)
                if fr["bboxes"][o.instance_id] is not None]
        mgr.update_nerf_bbox(idx, rows, 1)
    p0 = to_np(mgr.state.params)
    t0 = time.perf_counter()
    waves = mgr.pump()
    dt = time.perf_counter() - t0
    check(waves == 1, f"{waves} waves ran, expected 1")
    return mgr, p0, dt


def phase_cards(n_cards: int, card: str, n_objects: int = 10,
                capacity: int = 16, n_frames: int = 48, res: int = 480,
                iters: int = 20) -> None:
    from romap_tpu.data.synthetic import Camera, make_scene, make_sequence
    from romap_tpu.parallel import sharding

    check(len(jax.devices()) >= n_cards,
          f"--cards {n_cards}: JAX sees {len(jax.devices())} devices")
    cfg, _ = flagship("float32")
    cam = Camera(fx=res * 0.9, fy=res * 0.9, cx=res / 2, cy=res / 2, h=res, w=res)
    objects = make_scene(n_objects, seed=0)
    seq = make_sequence(cam, objects, n_frames, radius=5.5, seed=0)
    with jax.default_matmul_precision("highest"):
        many, p0, t_many = _manager_wave(sharding.make_mesh(n_cards), cfg, seq,
                                         cam, objects, capacity, iters)
        one, p0_one, t_one = _manager_wave(sharding.make_mesh(1), cfg, seq, cam,
                                           objects, capacity, iters)
    check(bool(np.all(flat(p0) == flat(p0_one))), "initial states differ")

    def devices_of(tree):
        return {d for leaf in jax.tree.leaves(tree)
                for d in leaf.sharding.device_set}

    want = set(jax.devices()[:n_cards])
    placed = {
        "state": devices_of(many.state),
        "frames": devices_of(many._frames()),
        "objects": devices_of(many._objects_state(np.ones(capacity, bool))),
    }
    for name, devs in placed.items():
        check(devs == want, f"{name} on {sorted(str(d) for d in devs)}, "
                            f"expected all {n_cards} cards")
    rows = {d: 0 for d in want}
    for s in many.state.loss.addressable_shards:
        rows[s.device] += s.data.shape[0]
    check(sorted(rows.values()) == [capacity // n_cards] * n_cards,
          f"object rows per card {rows}")

    l_many, l_one = many.losses(), one.losses()
    pm, po = to_np(many.state.params), to_np(one.state.params)
    rel = []
    for i in range(n_objects):
        upd = flat(jax.tree.map(lambda a: a[i], po)) - flat(jax.tree.map(lambda a: a[i], p0))
        gap = flat(jax.tree.map(lambda a: a[i], pm)) - flat(jax.tree.map(lambda a: a[i], po))
        rel.append(float(np.linalg.norm(gap) / np.linalg.norm(upd)))
    loss_rel = np.abs(l_many - l_one) / np.abs(l_one)
    log(f"cards: {n_cards}-card mesh vs 1-card mesh, NerfManagerOnline "
        f"capacity {capacity}, {n_objects} objects, one wave of {iters} iters, "
        f"float32 matmul precision highest; object rows per card "
        f"{sorted(rows.values())}; wave {t_many:.2f} s vs {t_one:.2f} s "
        f"(compile included) on {card}")
    log(f"cards: per-object loss {np.round(l_many, 6).tolist()} vs "
        f"{np.round(l_one, 6).tolist()}; max loss rel diff "
        f"{loss_rel.max():.3e} (tolerance 1e-3); params |gap|/|update| per "
        f"object max {max(rel):.3e} (tolerance 5e-2: summation order only)")
    check(np.isfinite(l_many).all() and loss_rel.max() <= 1e-3,
          f"loss rel diff {loss_rel}")
    check(max(rel) <= 5e-2, f"params gap/update {rel}")


# --------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=[1, 4],
                    help="4: run only the object-sharded table on four cards")
    ap.add_argument("--out", default=None,
                    help="directory for trace summaries (default: none)")
    args = ap.parse_args(argv)

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX finds no GPU (backend "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from romap_tpu.utils import jax_env

    cache_dir = jax_env.setup_compile_cache()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    t_start = time.perf_counter()
    dev = phase_device(cache_dir)
    if args.cards > 1:
        phase_cards(args.cards, dev["card"])
    else:
        work = tempfile.mkdtemp(prefix="romap_smoke_")
        try:
            for name, fn in (
                ("trainer", lambda: phase_trainer(dev["card"], cache_dir, args.out)),
                ("reference", lambda: phase_reference(trained)),
                ("server", lambda: phase_server(work)),
                ("offline", lambda: phase_offline(work)),
            ):
                t0 = time.perf_counter()
                res = fn()
                if name == "trainer":
                    trained = res
                log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
        finally:
            shutil.rmtree(work, ignore_errors=True)
    count = len(jax.devices())
    log(f"chip_smoke: all phases ok in {time.perf_counter() - t_start:.1f} s "
        f"on {dev['card']}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"], "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
