"""Typed configuration tree for the NeRF core.

Mirrors every knob of the reference's network config
(reference: dependencies/Multi-Object-NeRF/Core/configs/base.json and
Core/src/nerf_model.cu:1286-1342) plus the hard-coded constants collected in
BASELINE.md (batch sizes, lambdas, marching-cubes params).

Reference quirks reproduced deliberately:
  * the JSON's loss otype ("Huber") is overridden to L2 in code
    (nerf_model.cu:1296) — we only implement the L2 composite loss;
  * per-level scale is derived from desired resolution 2048, not read from the
    JSON (nerf_model.cu:1305-1306);
  * loss_scale=128 exists for fp16 gradient scaling (nerf_model.h:166); our
    gradients are fp32 so it is recorded but mathematically a no-op.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any


@dataclasses.dataclass(frozen=True)
class EncodingConfig:
    """Learned multiresolution spatial encoding.

    kind == "mxgrid": the gather-free factorized encoding (ops/mxgrid.py)
    — the flagship path.
    kind == "hashgrid": exact tcnn HashGrid semantics (ops/hashgrid.py,
    ref base.json:23-29) — reference parity.
    The hash-grid fields below also seed the mxgrid resolution ladder.
    """

    kind: str = "mxgrid"
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 16
    base_resolution: int = 16
    desired_resolution: float = 2048.0
    # mxgrid knobs — flagship defaults: CP 6 levels to 192 @ 48ch + one
    # RECTANGULAR (128,64,4) plane level with balanced axis assignment.
    # Quality, measured before the move to the GPU (5000 steps, seed 0):
    # 28.81 dB, 0.24 dB under the tcnn-semantics hash grid anchor (29.05),
    # inside BASELINE.md's 0.5 dB parity budget; 3-seed mean 25.95 vs 26.22
    # for the square (128,128,4) level. Below the parity floor (28.55):
    # CP k32 (28.39), p3 (28.44), rv=48 (27.80 uuv). The speed side of
    # this choice has not been measured on the GPU (see PERF.md).
    mx_levels: int = 6
    mx_max_resolution: int = 192
    mx_features: int = 48
    # VM plane-x-line components (TensoRF-style): restore full-rank texture
    # capacity that rank-limited CP lines lack. An int is a square plane;
    # an (ru, rv) pair is rectangular — the u axis contracts by matmul while
    # v reduces per point, so rv < ru trades v-detail for work
    # (flagship: (128, 64)). features 0 disables.
    mx_plane_res: int | tuple[int, int] = (128, 64)
    mx_plane_features: int = 4
    # Multi-level plane ladder — overrides the single mx_plane_res/
    # mx_plane_features level when set. Entries are (res, feats) squares or
    # (ru, rv, feats) rectangles.
    mx_plane_specs: tuple[tuple[int, ...], ...] | None = None
    # Plane-pair axis assignment: "uuv" (pairs contract x,x,y by matmul) or
    # "balanced" (every axis gets one fine-u and one coarse-v appearance —
    # matters for rectangular planes where rv < ru, where "uuv" starves z).
    mx_plane_axes: str = "balanced"
    # Fold the multi-level CP ladder through the finest level's tent basis
    # (mxgrid.MXGridSpec.snap_levels): coarse hats are snapped to fine-grid
    # knots and the fold matrix is absorbed into the line weights per step.
    # Cuts the hat-build and CP-matmul work ~2.4x at the flagship ladder.
    # Slightly different (equally valid) basis. Quality, measured before
    # the move to the GPU: its 3-seed parity gate at 0.052 dB (unsnapped
    # 0.189), and an online run within noise of the unsnapped one (21.19
    # vs 21.39 dB, IoU 0.990 both, seed 1). MX_SNAP=1/0 overrides at
    # runtime for A/B runs.
    mx_snap_levels: bool = True
    # hash-grid (tcnn-parity path) lookup implementation:
    # "gather" = direct XLA gather + scatter-add transpose;
    # "sorted" = argsort indices once, then sorted gather + sorted
    # segment-sum table gradient (removes the hash collisions a serialized
    # scatter-add would contend on; ROADMAP C2 decides whether it stays).
    hash_impl: str = "gather"

    @property
    def plane_specs(self) -> tuple[tuple[int, int], ...]:
        if self.mx_plane_specs is not None:
            return tuple(tuple(p) for p in self.mx_plane_specs)
        if self.mx_plane_features > 0:
            r = self.mx_plane_res
            ru, rv = (r, r) if isinstance(r, int) else tuple(r)
            if ru > 0:
                return ((ru, rv, self.mx_plane_features),)
        return ()

    @property
    def per_level_scale(self) -> float:
        # ref nerf_model.cu:1305-1306
        if self.n_levels <= 1:
            return 1.0
        return math.exp(
            math.log(self.desired_resolution / float(self.base_resolution))
            / (self.n_levels - 1)
        )

    @property
    def n_output_dims(self) -> int:
        if self.kind == "mxgrid":
            # plane specs are (res, k) pairs or rectangular (ru, rv, k)
            # triples — channels are always the last element
            return self.mx_features + 3 * sum(p[-1] for p in self.plane_specs)
        return self.n_levels * self.n_features_per_level

    @classmethod
    def preset(cls, name: str) -> "EncodingConfig":
        """Named encoding points. PSNRs are 5000-step seed-0 figures
        measured before the move to the GPU; their speed on the GPU is not
        measured yet (PERF.md).

        flagship — default: 28.81 dB (0.24 dB under the tcnn anchor,
                   inside the 0.5 dB budget).
        fast     — CP-only, 28.26 dB (outside the 0.5 dB parity budget).
        quality  — cp256_k64 + (128,8) planes, 29.29 dB (best PSNR).
        tcnn     — exact tcnn HashGrid semantics (29.05 dB; parity/debug).
        """
        presets = {
            "flagship": cls(),
            "fast": cls(mx_max_resolution=256, mx_features=64,
                        mx_plane_specs=()),
            "quality": cls(mx_max_resolution=256, mx_features=64,
                           mx_plane_res=128, mx_plane_features=8),
            "tcnn": cls(kind="hashgrid"),
        }
        if name not in presets:
            raise ValueError(
                f"unknown encoding preset {name!r}; "
                f"choose from {sorted(presets)}")
        return presets[name]


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Tiny MLP head, ref base.json:30-38 (FullyFusedMLP, bias-free)."""

    n_neurons: int = 64
    n_hidden_layers: int = 1
    # Activations fixed in code, not config: ref nerf_model.h mRgbActivation =
    # Logistic, mDensityActivation = Exponential.
    rgb_activation: str = "logistic"
    density_activation: str = "exponential"
    output_dims: int = 4  # rgb + sigma


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """EMA -> ExponentialDecay -> Adam chain, ref base.json:5-22."""

    learning_rate: float = 1e-2
    beta1: float = 0.9
    beta2: float = 0.99
    epsilon: float = 1e-15
    l2_reg: float = 1e-6
    ema_decay: float = 0.95
    decay_start: int = 20000
    decay_interval: int = 10000
    decay_base: float = 0.33


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Batch geometry + loss weights (ref nerf_model.h:166-175, common.h:12)."""

    rays_per_batch: int = 4096
    samples_per_ray: int = 32
    render_samples_per_ray: int = 64
    loss_scale: float = 128.0
    depth_lambda: float = 0.5  # ref nerf_model.cu:869
    mask_lambda: float = 0.5  # ref nerf_model.cu:927
    bg_sigma_reg: float = 0.01  # ref nerf_model.cu:940
    # Marching cubes (ref marching_cubes.h:30-31)
    mc_resolution: int = 64
    mc_threshold: float = 2.0
    # dtype of the compute path; params stay fp32 and the render/mesh paths
    # force fp32 regardless (ref renders fp32, nerf_model.cu:1795).
    # "auto" = bfloat16 on an accelerator (matches the reference's fp16
    # training), float32 on CPU (XLA CPU emulates bf16 slowly — tests/dev).
    compute_dtype: str = "auto"  # "auto" | "bfloat16" | "float32"


@dataclasses.dataclass(frozen=True)
class NerfConfig:
    encoding: EncodingConfig = EncodingConfig()
    network: NetworkConfig = NetworkConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    train: TrainConfig = TrainConfig()
    seed: int = 1337  # ref nerf_model.h m_seed = 1337


def load_network_config(path: str) -> NerfConfig:
    """Parse a reference-format network JSON (ref nerf_model.cu:1272-1284).

    Accepts the exact schema of Core/configs/base.json; unknown keys are
    ignored; the loss otype is ignored (forced L2, matching the reference).
    """
    with open(path) as f:
        cfg: dict[str, Any] = json.load(f)

    enc = cfg.get("encoding", {})
    encoding = EncodingConfig(
        n_levels=int(enc.get("n_levels", 16)),
        n_features_per_level=int(enc.get("n_features_per_level", 2)),
        log2_hashmap_size=int(enc.get("log2_hashmap_size", 15)),
        base_resolution=int(enc.get("base_resolution", 16)),
    )

    net = cfg.get("network", {})
    network = NetworkConfig(
        n_neurons=int(net.get("n_neurons", 64)),
        n_hidden_layers=int(net.get("n_hidden_layers", 1)),
    )

    # optimizer chain: Ema{ ExponentialDecay{ Adam } } (base.json:5-22)
    opt = cfg.get("optimizer", {})
    ema_decay = 0.95
    decay_start, decay_interval, decay_base = 20000, 10000, 0.33
    adam: dict[str, Any] = {}
    node = opt
    for _ in range(4):
        otype = str(node.get("otype", "")).lower()
        if otype == "ema":
            ema_decay = float(node.get("decay", 0.95))
        elif otype == "exponentialdecay":
            decay_start = int(node.get("decay_start", 20000))
            decay_interval = int(node.get("decay_interval", 10000))
            decay_base = float(node.get("decay_base", 0.33))
        elif otype == "adam":
            adam = node
        node = node.get("nested", {})
        if not node:
            break

    optimizer = OptimizerConfig(
        learning_rate=float(adam.get("learning_rate", 1e-2)),
        beta1=float(adam.get("beta1", 0.9)),
        beta2=float(adam.get("beta2", 0.99)),
        epsilon=float(adam.get("epsilon", 1e-15)),
        l2_reg=float(adam.get("l2_reg", 1e-6)),
        ema_decay=ema_decay,
        decay_start=decay_start,
        decay_interval=decay_interval,
        decay_base=decay_base,
    )

    return NerfConfig(encoding=encoding, network=network, optimizer=optimizer)
