#!/bin/bash
# BO regret study: seeds 0-4 x {BARK, Random} x {TreeFunction, PestControl}.
# Each run is its own process (the XLA CPU backend aborts after ~60 compiled
# programs in one process; see pyproject), run one after another on the CPU
# (--platform cpu), so no two ever share a card. Results land in
# results/regret_r2.
set -u
cd "$(dirname "$0")/.."
OUT=${1:-results/regret_r2}
for bench in treefunction pestcontrol; do
  for model in bark random; do
    for seed in 0 1 2 3 4; do
      tag="${bench}_${model}_s${seed}"
      echo "=== $tag ==="
      timeout 1800 python examples/bark_study.py -s "$seed" \
        -c "examples/configs/benchmark_${bench}.yaml" \
        -m "examples/configs/model_${model}.yaml" \
        -o "$OUT" --platform cpu 2>&1 | tail -2
    done
  done
done
echo "ALL DONE"
