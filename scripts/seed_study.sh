#!/bin/bash
# Multi-seed online robustness study (VERDICT round-2 item 1's >=3-run
# criterion). Same-seed runs are bit-identical since the heap-layout
# determinism fix, so spread comes from varying the scene draw
# (ROMAP_DEMO_SEED). Each run = full online pipeline on the GPU:
# dense-view + sparse-depth + refined eval poses, 300-iter waves.
#
# usage: scripts/seed_study.sh <out_root> <mode:dense|kf> <seed> [<seed>...]
# Appends one JSON line per run to <out_root>/study.jsonl. Skips runs whose
# eval.json already exists (resumable).
set -e
REPO="$(cd "$(dirname "$0")/.." && pwd)"
ROOT="${1:?out_root}"; MODE="${2:?mode}"; shift 2
mkdir -p "$ROOT"
for SEED in "$@"; do
  OUT="$ROOT/${MODE}_seed${SEED}"
  if [ -f "$OUT/eval.json" ]; then
    echo "== $MODE seed $SEED: already done =="
    continue
  fi
  # a previous timed-out run may have left its server holding the card
  if [ -f "$OUT/server.pid" ]; then
    kill "$(cat "$OUT/server.pid")" 2>/dev/null || true
    sleep 2
    kill -9 "$(cat "$OUT/server.pid")" 2>/dev/null || true
    rm -f "$OUT/server.pid"
  fi
  echo "== $MODE seed $SEED =="
  ENV=(ROMAP_DEMO_SEED="$SEED" ROMAP_DEMO_SPARSE_DEPTH=1 ROMAP_NO_VIDEO=1)
  [ "$MODE" = dense ] && ENV+=(ROMAP_DENSE_VIEWS=1)
  # -k 30: SIGKILL grace period; the demo script traps TERM and kills its
  # server + mono_tum children (the EXIT trap alone never ran on timeout)
  env "${ENV[@]}" timeout -k 30 2100 "$REPO/examples/run_online_demo.sh" \
    "$OUT" 300 gpu || echo "(run failed: $MODE seed $SEED)"
  # only append a row when eval.json exists — failed runs are retried on
  # the next invocation (appending error rows would duplicate keys)
  if [ -f "$OUT/eval.json" ]; then
  python - "$ROOT/study.jsonl" "$MODE" "$SEED" "$OUT/eval.json" <<'EOF'
import json, sys
path, mode, seed, ev = sys.argv[1:]
row = {"mode": mode, "seed": int(seed)}
d = json.load(open(ev))
agg, objs = d.get("aggregate", {}), d.get("objects", {})
row["psnr_db"] = agg.get("mean_psnr_db")
row["mask_iou"] = agg.get("mean_mask_iou")
ssims = [m["ssim"] for m in objs.values() if m.get("ssim") is not None]
row["ssim"] = round(sum(ssims) / len(ssims), 4) if ssims else None
with open(path, "a") as f:
    f.write(json.dumps(row) + "\n")
print("recorded:", row)
EOF
  fi
done
