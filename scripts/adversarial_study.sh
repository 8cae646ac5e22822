#!/bin/bash
# Adversarial-scene study (VERDICT r4 next #2): for each adversarial scene
# (non-sphere geometry / detector noise / exposure drift — data/world.py
# write_adversarial_dataset), run the FULL online pipeline AND an offline
# GT-pose ceiling on the SAME degraded dataset, then append one
# ceiling-normalized JSON row per scene to <out_root>/study.jsonl.
#
# usage: scripts/adversarial_study.sh <out_root> [scene ...]
#        (default scenes: concave boxnoise compound exposure)
# Resumable: skips runs whose eval.json already exists.
set -e
REPO="$(cd "$(dirname "$0")/.." && pwd)"
ROOT="${1:?out_root}"; shift || true
SCENES=("$@")
[ ${#SCENES[@]} -eq 0 ] && SCENES=(concave boxnoise compound exposure)
mkdir -p "$ROOT"

for SC in "${SCENES[@]}"; do
  OUT="$ROOT/${SC}_online"
  if [ ! -f "$OUT/eval.json" ]; then
    # a previous timed-out run may have left its server holding the card
    if [ -f "$OUT/server.pid" ]; then
      kill "$(cat "$OUT/server.pid")" 2>/dev/null || true
      sleep 2
      kill -9 "$(cat "$OUT/server.pid")" 2>/dev/null || true
      rm -f "$OUT/server.pid"
    fi
    echo "== online: scene $SC =="
    env ROMAP_DEMO_SCENE="$SC" ROMAP_DEMO_SPARSE_DEPTH=1 ROMAP_DENSE_VIEWS=1 \
      ROMAP_NO_VIDEO=1 timeout -k 30 2100 \
      "$REPO/examples/run_online_demo.sh" "$OUT" 300 gpu \
      || echo "(online run failed: $SC)"
  else
    echo "== online: scene $SC already done =="
  fi

  OFF="$ROOT/${SC}_offline"
  if [ ! -f "$OFF/eval.json" ] && [ -d "$OUT/dataset" ]; then
    echo "== offline ceiling: scene $SC =="
    mkdir -p "$OFF"
    # --holdout 4: leakage-free ceiling — train WITHOUT every 4th view and
    # eval on exactly those (the online pipeline never uploads its held-out
    # frames; a ceiling trained on its own eval views would be inflated)
    PYTHONPATH="$REPO:$PYTHONPATH" timeout -k 30 2400 python -m \
      romap_tpu.runtime.offline - "$OUT/dataset" 1 --out "$OFF" --no-video \
      --holdout 4 > "$OFF/offline.log" 2>&1 || echo "(offline run failed: $SC)"
    PYTHONPATH="$REPO:$PYTHONPATH" python -m romap_tpu.utils.eval_psnr \
      "$OFF" "$OUT/dataset" --json "$OFF/eval.json" || true
  fi

  if [ -f "$OUT/eval.json" ]; then
    python - "$ROOT/study.jsonl" "$SC" "$OUT/eval.json" \
      "$OFF/eval.json" <<'EOF'
import json, os, sys
path, scene, ev_on, ev_off = sys.argv[1:]
row = {"scene": scene}
d = json.load(open(ev_on))
agg, objs = d.get("aggregate", {}), d.get("objects", {})
row["psnr_db"] = agg.get("mean_psnr_db")
row["mask_iou"] = agg.get("mean_mask_iou")
o0 = next(iter(objs.values()), {})
for k in ("mesh_chamfer_norm", "mesh_scale_ratio", "mesh_radius_ratio"):
    if k in o0:
        row[k] = o0[k]
cu = d.get("cuboids", {})
if cu:
    row["cuboid_center_err"] = cu.get("mean_center_err")
    row["cuboid_ext_err_max"] = cu.get("mean_ext_err_max")
if os.path.exists(ev_off):
    off = json.load(open(ev_off))
    row["ceiling_psnr_db"] = off.get("aggregate", {}).get("mean_psnr_db")
    ochamf = next(iter(off.get("objects", {}).values()), {}).get(
        "mesh_chamfer_norm")
    if ochamf is not None:
        row["ceiling_chamfer_norm"] = ochamf
    if row.get("psnr_db") is not None and row.get("ceiling_psnr_db"):
        row["gap_db"] = round(row["ceiling_psnr_db"] - row["psnr_db"], 2)
# replace any stale row for this scene (re-runs), keep one row per scene
rows = []
if os.path.exists(path):
    rows = [json.loads(l) for l in open(path) if l.strip()]
rows = [r for r in rows if r.get("scene") != scene] + [row]
with open(path, "w") as f:
    for r in rows:
        f.write(json.dumps(r) + "\n")
print("recorded:", row)
EOF
  fi
done
