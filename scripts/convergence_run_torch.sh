#!/bin/bash
# Synthetic convergence gate of the PyTorch port, the counterpart of
# scripts/convergence_run.sh: train MODEL for EPOCHS epochs through
# `python -m cmflow_tpu_torch.cli.main` on the same 320/48/16-sample
# synthetic VoD-layout set (clips_per_partition=8, seed=5), then assert on
# the best epoch's val RNE: below 0.6x the first epoch's, and at or below
# the family's bar (cmflow 0.105, raflow 0.160, cmflow_t 0.130), the same
# in float32 and bf16.  Needs neither PyYAML nor matplotlib.  Runs on the
# GPU unless PLATFORM=cpu.
#
#   scripts/convergence_run_torch.sh                  # cmflow, 24 epochs
#   MODEL=raflow EPOCHS=48 scripts/convergence_run_torch.sh
#   MODEL=cmflow_t scripts/convergence_run_torch.sh   # mini-clips of 5
#   OUT=build/convergence_torch.jsonl scripts/convergence_run_torch.sh
#   DTYPE=bfloat16 EPOCHS=36 scripts/convergence_run_torch.sh  # bf16 train
#
# RaFlow's self-supervised loss needs more epochs: the JAX f32 run reached
# 0.156 in 36 (scripts/convergence_run.sh:12-14).  CMFlow_T trains on
# mini-clips (configs/cmflow_t.yaml: vodClipDataset), one optimizer step per
# frame, and validates its clips side by side.  DTYPE=bfloat16 trains the
# bf16 chain (--compute_dtype bfloat16: bf16 activations, float32
# parameters and BatchNorm); the JAX package's bf16 runs on the TPU reached
# 0.0954 (cmflow, 36 epochs), 0.1573 (raflow, 48) and 0.1265 (cmflow_t, 36)
# (scripts/convergence_run.sh:23-27).  Validation serves in float32, the
# config's eval_compute_dtype.
#
# Env knobs: MODEL (cmflow|raflow|cmflow_t), DS (dataset dir, default
# build/conv_ds), EXP (exp name; default conv_torch_$MODEL, with _bf16 for
# bf16), DTYPE (float32|bfloat16), PLATFORM (auto|cpu), EPOCHS, BATCH, OUT
# (copy of the run's metrics, first line the run parameters).
set -e
MODEL=${MODEL:-cmflow}
DS=${DS:-build/conv_ds}
DTYPE=${DTYPE:-float32}
if [ "$DTYPE" = float32 ]; then
  EXP=${EXP:-conv_torch_${MODEL}}
else
  EXP=${EXP:-conv_torch_${MODEL}_${DTYPE}}
fi
PLATFORM=${PLATFORM:-auto}
EPOCHS=${EPOCHS:-24}
BATCH=${BATCH:-16}
if [ ! -d "$DS" ]; then
  python - <<PY
from cmflow_tpu_torch.data.synthetic import write_synthetic_dataset
write_synthetic_dataset("$DS", {"train": 320, "val": 48, "test": 16},
                        clips_per_partition=8, seed=5)
PY
fi
# MetricsWriter appends: set any earlier run's metrics aside so the gate
# reads exactly one run
if [ -f "checkpoints/$EXP/metrics.jsonl" ]; then
  mv "checkpoints/$EXP/metrics.jsonl" \
     "checkpoints/$EXP/metrics.$(date +%s).jsonl"
fi
python -m cmflow_tpu_torch.cli.main --config "configs/${MODEL}.yaml" \
  --dataset_path "$DS" --exp_name "$EXP" --epochs "$EPOCHS" \
  --batch_size "$BATCH" --compute_dtype "$DTYPE" --platform "$PLATFORM"
if [ -n "$OUT" ]; then
  python - <<PY
import json
hdr = {"run": {"model": "$MODEL", "dtype": "$DTYPE",
               "platform": "$PLATFORM", "epochs": int("$EPOCHS"),
               "batch_size": int("$BATCH"), "dataset": "synthetic-320"}}
with open("$OUT", "w") as f:
    f.write(json.dumps(hdr) + "\n")
    f.writelines(open("checkpoints/$EXP/metrics.jsonl"))
print("wrote $OUT")
PY
fi
python - <<PY
import json
# the same per-family absolute val-RNE bars as scripts/convergence_run.sh
ABS = {"cmflow": 0.105, "raflow": 0.160, "cmflow_t": 0.130}
rows = [json.loads(l) for l in open("checkpoints/$EXP/metrics.jsonl")]
rnes = [r["rne"] for r in rows if "rne" in r]
print("val RNE by epoch:", " ".join(f"{x:.4f}" for x in rnes))
assert min(rnes) < 0.6 * rnes[0], \
    f"no convergence: {rnes[0]} -> best {min(rnes)}"
bar = ABS["$MODEL"]
assert min(rnes) <= bar, \
    f"plateaued above the absolute bar: min RNE {min(rnes):.4f} > {bar}"
print(f"converged: val RNE {rnes[0]:.4f} -> {min(rnes):.4f} (bar {bar})")
PY
