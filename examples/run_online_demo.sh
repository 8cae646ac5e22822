#!/bin/bash
# Full online RO-MAP pipeline demo: C++ monocular SLAM frontend -> socket ->
# GPU/CPU NeRF runtime -> evaluation artifacts. The server is the only JAX
# process: one JAX process opens a card at a time.
#
# usage: examples/run_online_demo.sh [out_dir] [train_iters] [gpu|cpu] [n_objects] [final_waves]
set -e
REPO="$(cd "$(dirname "$0")/.." && pwd)"
OUT="${1:-/tmp/romap_online_demo}"
ITERS="${2:-100}"
PLATFORM="${3:-cpu}"
NOBJ="${4:-1}"
FINALW="${5:-1}"
DATASET="$OUT/dataset"
SOCK="$OUT/monerf.sock"

mkdir -p "$OUT"
cmake -S "$REPO/native" -B "$REPO/native/build" -G Ninja >/dev/null
cmake --build "$REPO/native/build" >/dev/null

echo "== generating synthetic dataset =="
# ROMAP_DEMO_SEED varies the scene draw (object placement/texture): SLAM
# runs are deterministic per dataset since the heap-layout-determinism fix,
# so multi-run spread studies must vary the seed, not just re-run.
# ROMAP_DEMO_SCENE selects the scene: room (default) or an adversarial
# variant (concave | boxnoise | compound | exposure — world.py).
SEED="${ROMAP_DEMO_SEED:-0}"
SCENE="${ROMAP_DEMO_SCENE:-room}"
PYTHONPATH="$REPO:$PYTHONPATH" python -c "
from romap_tpu.data import world
if '$SCENE' == 'room':
    world.write_room_dataset('$DATASET', n_objects=$NOBJ, seed=$SEED)
else:
    world.write_adversarial_dataset('$DATASET', '$SCENE', seed=$SEED)
print('dataset at $DATASET (scene $SCENE, seed $SEED)')"

# ROMAP_DEMO_SPARSE_DEPTH=1: enable the NeRF.UseSparseDepth yaml knob
# (SLAM ships its BA-refined sparse depth as a supervision channel)
[ -n "$ROMAP_DEMO_SPARSE_DEPTH" ] && \
  echo "NeRF.UseSparseDepth: 1" >> "$DATASET/config.yaml"

echo "== starting NeRF runtime server ($PLATFORM) =="
rm -f "$SOCK"
case "$PLATFORM" in
  gpu) PLATFORM_FLAG="--platform gpu" ;;
  cpu) PLATFORM_FLAG="--platform cpu --small" ;;
  *) echo "platform must be gpu or cpu, not '$PLATFORM'" >&2; exit 2 ;;
esac
# ROMAP_DEMO_NO_FINAL_RETRAIN=1: keep the accumulated field at shutdown
# (reference-parity; A/B for the retrain-vs-midrun-poses interplay)
[ -n "$ROMAP_DEMO_NO_FINAL_RETRAIN" ] && \
  PLATFORM_FLAG="$PLATFORM_FLAG --no-final-retrain"
# ROMAP_DEMO_JOINT_BA=N: run N shutdown joint pose+field BA iterations
[ -n "$ROMAP_DEMO_JOINT_BA" ] && \
  PLATFORM_FLAG="$PLATFORM_FLAG --joint-ba $ROMAP_DEMO_JOINT_BA"
# The server keeps its persistent compile cache where
# JAX_COMPILATION_CACHE_DIR says, else in <repo>/.jax_cache.
PYTHONPATH="$REPO:$PYTHONPATH" python -m romap_tpu.runtime.server \
  --socket "$SOCK" --final-waves "$FINALW" $PLATFORM_FLAG > "$OUT/server.log" 2>&1 &
SRV=$!
echo "$SRV" > "$OUT/server.pid"
MONO=""
# Kill both children on ANY exit path. TERM/INT are trapped explicitly:
# bash does not run the EXIT trap on an untrapped fatal signal, which would
# orphan the server (holding the card) when a caller's `timeout` fired.
# TERM first, then KILL after a grace period: a server blocked in a long
# device call does not run Python's TERM handling, and a leftover server
# holds the card's memory against every later run.
cleanup() {
  [ -n "$MONO" ] && kill "$MONO" 2>/dev/null
  kill "$SRV" 2>/dev/null
  for i in $(seq 1 10); do kill -0 "$SRV" 2>/dev/null || break; sleep 1; done
  kill -9 "$SRV" 2>/dev/null
  rm -f "$OUT/server.pid"
  return 0
}
trap cleanup EXIT
trap 'cleanup; exit 143' TERM INT
for i in $(seq 1 120); do [ -S "$SOCK" ] && break; sleep 1; done

echo "== running mono_tum (SLAM + online NeRF) =="
# Run in the background and `wait` (interruptible) — a foreground child
# would defer bash's signal traps until it exited on its own.
"$REPO/native/build/mono_tum" "$DATASET" "$SOCK" "$ITERS" "$OUT" & MONO=$!
wait "$MONO"
MONO=""

echo "== artifacts =="
ls "$OUT"
ls "$OUT/0" 2>/dev/null || true

echo "== evaluation (PSNR/SSIM/mask IoU over held-out renders) =="
PYTHONPATH="$REPO:$PYTHONPATH" python -m romap_tpu.utils.eval_psnr \
  "$OUT" "$DATASET" --json "$OUT/eval.json" || true
cat "$OUT/eval.json" 2>/dev/null || true
