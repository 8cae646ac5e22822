"""NeRF runtime server: the JAX process behind the C++ manager shim.

The reference links the SLAM frontend directly against libMON.so (CUDA in
the same process). The JAX runtime lives in its own process, so the C++
`nerf::NerfManagerOnline` shim (native/) speaks a length-prefixed binary
protocol over a UNIX domain socket to this server, which forwards onto
runtime/manager.NerfManagerOnline. One frame:

    u32 opcode | u32 payload_len | payload        (little-endian)
reply:
    u32 status (0 ok)   | u32 len | payload

Opcodes (keep in sync with native/include/monerf/ipc.h):
  1 INIT          u8 use_depth, i32 train_iters, i32 capacity, u8 mesh_on
  2 DATASET_INIT  f32 fx fy cx cy, i32 h w imgs
  3 NEW_FRAME     i32 img_id, u16 slen, stamp, u8 has_depth,
                  u8 rgb[h*w*3], u8 instance[h*w], (f32 depth[h*w]),
                  f32 pose[16] row-major
  4 CREATE_NERF   i32 cls, f32 tow[16], f32 bbmin[3], f32 bbmax[3]
                  -> i32 idx, f32 aabb_half[3] (actual training-volume
                  half-widths, inflation included — single source of truth)
  5 UPDATE_BBOX   i32 idx, i32 train_step, i32 n, i32 rows[n*5]
  6 GET_FRAME_IDX u16 slen, stamp -> i32 idx
  7 WAIT_END      -> ack
  8 RENDER_TEST   i32 idx, f32 radius, u8 video, u16 plen, path, i32 n,
                  n x (u16 slen, stamp, i32 box[4], f32 twc[16],
                       u8 has_pixels, (u8 rgb[h*w*3], u8 mask[h*w])) -> ack
                  (pixels = bbox crops of the ORIGINAL image + object mask;
                   when present the runtime photometrically refines that
                   view's pose against the trained field before rendering)
  9 GET_MESH      i32 idx -> i32 nv, i32 nf, f32 v[nv*3], f32 n[nv*3],
                  u8 c[nv*3], i32 f[nf*3]
 10 UPDATE_POSES  i32 cur_id, i32 n, f32 poses[n*16] -> ack
 11 GET_LOSSES    -> i32 n, f32 loss[n]
 12 SHUTDOWN      -> ack, server exits
 13 PUMP          i32 max_waves (-1 = drain) -> i32 waves_run
 14 START         -> ack (background pump thread)
 15 UPDATE_VOLUME i32 idx, f32 tow[16], f32 bbmin[3], f32 bbmax[3]
                  -> f32 aabb_half[3] (zeros for a stale slot index)
"""

from __future__ import annotations

import argparse
import os
import socket
import struct
import sys
import threading
import time

import numpy as np

from romap_tpu.config import NerfConfig
from romap_tpu.runtime.manager import NerfManagerOnline

OPS = {
    "INIT": 1, "DATASET_INIT": 2, "NEW_FRAME": 3, "CREATE_NERF": 4,
    "UPDATE_BBOX": 5, "GET_FRAME_IDX": 6, "WAIT_END": 7, "RENDER_TEST": 8,
    "GET_MESH": 9, "UPDATE_POSES": 10, "GET_LOSSES": 11, "SHUTDOWN": 12,
    "PUMP": 13, "START": 14, "UPDATE_VOLUME": 15,
}


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, fmt: str):
        vals = struct.unpack_from("<" + fmt, self.data, self.off)
        self.off += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def take_str(self) -> str:
        n = self.take("H")
        s = self.data[self.off : self.off + n].decode()
        self.off += n
        return s

    def take_array(self, dtype, count) -> np.ndarray:
        a = np.frombuffer(self.data, dtype, count, self.off).copy()
        self.off += a.nbytes
        return a


class RuntimeServer:
    def __init__(self, cfg: NerfConfig | None = None, final_waves: int = 1,
                 joint_ba: int = 0, final_retrain: bool = True):
        self.base_cfg = cfg or NerfConfig()
        self.final_waves = max(1, final_waves)  # shutdown polish waves
        self.joint_ba = max(0, joint_ba)  # shutdown joint pose+field BA iters
        self.final_retrain = bool(final_retrain)  # shutdown from-scratch retrain
        self.mgr: NerfManagerOnline | None = None
        self._h = self._w = 0
        self._running = True
        # Stall watchdog (failure detection the reference lacks): a hung
        # device call would otherwise wedge the whole pipeline silently in
        # one opcode. Warn after ROMAP_WATCHDOG_S (default 600 s —
        # WAIT_END/RENDER_TEST legitimately run minutes at full size),
        # escalate each further threshold; ROMAP_WATCHDOG_FATAL=1 kills
        # the process at 2x so the client's recv fails fast instead of
        # blocking forever.
        self._watchdog_s = float(os.environ.get("ROMAP_WATCHDOG_S", "600"))
        self._watchdog_fatal = os.environ.get("ROMAP_WATCHDOG_FATAL") == "1"
        self._inflight: tuple[int, float] | None = None  # (op, start time)
        self._warned_at = 0.0

    def _watchdog_check(self, now: float) -> str | None:
        """One watchdog poll: a warning line if the in-flight op crossed
        the stall threshold (re-warns each further threshold), else None.
        Returns the string rather than printing so tests can drive it."""
        snap = self._inflight
        if snap is None or self._watchdog_s <= 0:
            return None
        op, t0 = snap
        dt = now - t0
        if dt < self._watchdog_s or now - self._warned_at < self._watchdog_s:
            return None
        self._warned_at = now
        name = next((k for k, v in OPS.items() if v == op), str(op))
        return (f"WATCHDOG: opcode {name} in flight for {dt:.0f}s "
                f"(threshold {self._watchdog_s:.0f}s) — the device may "
                f"be stalled")

    def _watchdog_loop(self) -> None:
        while self._running:
            time.sleep(min(30.0, max(1.0, self._watchdog_s / 4)))
            now = time.monotonic()
            msg = self._watchdog_check(now)
            if msg:
                print(msg, file=sys.stderr, flush=True)
                snap = self._inflight
                if (self._watchdog_fatal and snap is not None
                        and now - snap[1] >= 2 * self._watchdog_s):
                    print("WATCHDOG: fatal — exiting so clients unblock",
                          file=sys.stderr, flush=True)
                    os._exit(86)

    # ---------------------------------------------------------------- ops
    def handle(self, op: int, payload: bytes) -> bytes:
        r = _Reader(payload)
        if op == OPS["INIT"]:
            use_depth = bool(r.take("B"))
            iters, capacity = r.take("i"), r.take("i")
            mesh_on = bool(r.take("B"))
            self.mgr = NerfManagerOnline(
                self.base_cfg, use_sparse_depth=use_depth,
                train_step_iterations=iters, capacity=capacity,
                mesh_enabled=mesh_on, final_waves=self.final_waves,
                joint_ba_iters=self.joint_ba,
                final_retrain=self.final_retrain,
            )
            return b""
        if op == OPS["DATASET_INIT"]:
            fx, fy, cx, cy = r.take("ffff")
            h, w, imgs = r.take("iii")
            self._h, self._w = h, w
            self.mgr.dataset_init(fx, fy, cx, cy, h, w, imgs)
            return b""
        if op == OPS["NEW_FRAME"]:
            img_id = r.take("i")
            stamp = r.take_str()
            has_depth = bool(r.take("B"))
            h, w = self._h, self._w
            rgb = r.take_array(np.uint8, h * w * 3).reshape(h, w, 3)
            inst = r.take_array(np.uint8, h * w).reshape(h, w)
            depth = None
            if has_depth:
                depth = r.take_array(np.float32, h * w).reshape(h, w)
            pose = r.take_array(np.float32, 16).reshape(4, 4)
            self.mgr.new_frame_to_dataset(img_id, stamp, rgb, inst, depth, pose)
            return b""
        if op == OPS["CREATE_NERF"]:
            cls = r.take("i")
            tow = r.take_array(np.float32, 16).reshape(4, 4)
            bbmin = r.take_array(np.float32, 3)
            bbmax = r.take_array(np.float32, 3)
            idx = self.mgr.create_nerf(cls, tow, bbmin, bbmax)
            half = self.mgr.aabb_half(idx)
            return struct.pack("<ifff", idx, *half)
        if op == OPS["UPDATE_VOLUME"]:
            idx = r.take("i")
            tow = r.take_array(np.float32, 16).reshape(4, 4)
            bbmin = r.take_array(np.float32, 3)
            bbmax = r.take_array(np.float32, 3)
            if self.mgr.update_nerf_volume(idx, tow, bbmin, bbmax):
                half = self.mgr.aabb_half(idx)
            else:  # stale/out-of-range slot (e.g. after a SLAM reset): no-op
                half = (0.0, 0.0, 0.0)
            return struct.pack("<fff", *half)
        if op == OPS["UPDATE_BBOX"]:
            idx, train_step, n = r.take("iii")
            rows = r.take_array(np.int32, n * 5).reshape(n, 5)
            self.mgr.update_nerf_bbox(idx, rows, train_step)
            return b""
        if op == OPS["GET_FRAME_IDX"]:
            return struct.pack("<i", self.mgr.get_frame_idx(r.take_str()))
        if op == OPS["WAIT_END"]:
            self.mgr.wait_threads_end()
            return b""
        if op == OPS["RENDER_TEST"]:
            idx = r.take("i")
            radius = r.take("f")
            video = bool(r.take("B"))
            path = r.take_str()
            n = r.take("i")
            stamps, boxes, twcs, pixels = [], [], [], []
            for _ in range(n):
                stamps.append(r.take_str())
                box = tuple(int(v) for v in r.take_array(np.int32, 4))
                boxes.append(box)
                twcs.append(r.take_array(np.float32, 16).reshape(4, 4))
                if bool(r.take("B")):
                    bh, bw = box[2], box[3]
                    rgb = r.take_array(np.uint8, bh * bw * 3).reshape(bh, bw, 3)
                    msk = r.take_array(np.uint8, bh * bw).reshape(bh, bw)
                    pixels.append((rgb, msk))
                else:
                    pixels.append(None)
            self.mgr.render_nerfs_test(path, idx, stamps, boxes, twcs, radius,
                                       video=video, pixels=pixels)
            return b""
        if op == OPS["GET_MESH"]:
            idx = r.take("i")
            mesh = self.mgr.get_mesh(idx)
            if mesh is None:
                return struct.pack("<ii", 0, 0)
            v = np.asarray(mesh.verts, np.float32)
            nrm = (np.asarray(mesh.normals, np.float32)
                   if mesh.normals is not None else np.zeros_like(v))
            col = (np.clip(np.asarray(mesh.colors) * 255, 0, 255).astype(np.uint8)
                   if mesh.colors is not None else np.zeros(v.shape, np.uint8))
            f = np.asarray(mesh.faces, np.int32)
            return (struct.pack("<ii", len(v), len(f)) + v.tobytes()
                    + nrm.tobytes() + col.tobytes() + f.tobytes())
        if op == OPS["UPDATE_POSES"]:
            cur_id, n = r.take("ii")
            poses = r.take_array(np.float32, n * 16).reshape(n, 4, 4)
            self.mgr.update_dataset(cur_id, n, poses)
            return b""
        if op == OPS["GET_LOSSES"]:
            losses = self.mgr.losses().astype(np.float32)
            return struct.pack("<i", len(losses)) + losses.tobytes()
        if op == OPS["SHUTDOWN"]:
            self._running = False
            return b""
        if op == OPS["PUMP"]:
            mx = r.take("i")
            return struct.pack("<i", self.mgr.pump(None if mx < 0 else mx))
        if op == OPS["START"]:
            self.mgr.start()
            return b""
        raise ValueError(f"unknown opcode {op}")

    # --------------------------------------------------------------- serve
    def serve(self, sock_path: str) -> None:
        if os.path.exists(sock_path):
            os.unlink(sock_path)
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(sock_path)
        srv.listen(1)
        print(f"READY {sock_path}", flush=True)
        threading.Thread(target=self._watchdog_loop, daemon=True).start()
        while self._running:
            conn, _ = srv.accept()
            try:
                while self._running:
                    head = _recv_exact(conn, 8)
                    op, n = struct.unpack("<II", head)
                    payload = _recv_exact(conn, n) if n else b""
                    self._inflight = (op, time.monotonic())
                    try:
                        reply = self.handle(op, payload)
                        conn.sendall(struct.pack("<II", 0, len(reply)) + reply)
                    except Exception as e:  # report error to client
                        msg = f"{type(e).__name__}: {e}".encode()
                        conn.sendall(struct.pack("<II", 1, len(msg)) + msg)
                        if op == OPS["SHUTDOWN"]:
                            raise
                    finally:
                        self._inflight = None
            except (ConnectionError, OSError):
                pass
            finally:
                conn.close()
        srv.close()
        os.unlink(sock_path)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--socket", required=True)
    ap.add_argument("--config", default=None,
                    help="reference-format network JSON")
    ap.add_argument("--small", action="store_true",
                    help="tiny config (tests)")
    ap.add_argument("--final-waves", type=int, default=1,
                    help="training waves per object at shutdown (1 = "
                         "reference parity; more polishes convergence on "
                         "the final keyframe set)")
    ap.add_argument("--joint-ba", type=int, default=0,
                    help="shutdown joint photometric BA iterations: "
                         "optimize a shared per-keyframe SE(3) correction "
                         "jointly with the fields (BARF-style), fold the "
                         "deltas into the stored keyframe poses, then run "
                         "the final waves (0 = off/reference parity)")
    ap.add_argument("--no-final-retrain", action="store_true",
                    help="skip the shutdown from-scratch retrain (the "
                         "default re-inits each slot and re-runs its wave "
                         "budget AFTER the frontend's final BA-refined "
                         "pose upload, so eval-facing fields train on the "
                         "refined pose graph end to end)")
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                    help="cpu pins JAX to the host; gpu fails unless JAX "
                         "finds a GPU (default: JAX's own choice)")
    return ap


def main() -> None:
    args = build_parser().parse_args()
    from romap_tpu.utils import jax_env

    jax_env.select_platform(args.platform)
    jax_env.setup_compile_cache()
    cfg = None
    if args.config:
        from romap_tpu.config import load_network_config

        cfg = load_network_config(args.config)
    if args.small:
        from romap_tpu.config import EncodingConfig, TrainConfig

        cfg = NerfConfig(
            encoding=EncodingConfig(kind="mxgrid", mx_levels=3,
                                    mx_max_resolution=64, mx_features=16,
                                mx_plane_res=32, mx_plane_features=8),
            train=TrainConfig(rays_per_batch=512, samples_per_ray=16,
                              mc_resolution=17),
        )
    RuntimeServer(cfg, final_waves=args.final_waves,
                  joint_ba=args.joint_ba,
                  final_retrain=not args.no_final_retrain).serve(args.socket)


if __name__ == "__main__":
    main()
