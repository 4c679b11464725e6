#!/usr/bin/env bash
# Compare two trees on one card: run each one's chip_smoke.py from its own
# root, alternately (parent, change, change, parent, parent, change), and
# print the lines that carry the attention, fused MRF (float32 and bf16),
# training, int8 conv (per batch, serve and stage, and a launch's fixed
# cost) and GEMM numbers, bench.py's fused and int8 batches and phase 11's
# parity readings. Full logs
# go to chiprun_out/pairs/<n>_<P|C>.log.
#
#   bash parrot_tts_tpu_torch/scripts/smoke_pairs.sh PARENT_ROOT [ORDER [CHANGE_ROOT]]
#
# PARENT_ROOT: a checkout of the parent commit (for example `git archive`
# unpacked into build/parent); CHANGE_ROOT, the change, defaults to the
# current directory (for example the final tree unpacked into build/final).
# ORDER defaults to "P C C P P C".
set -u
parent=$1
order=${2:-"P C C P P C"}
change=${3:-.}
mkdir -p chiprun_out/pairs
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
i=0
for who in $order; do
  i=$((i + 1))
  if [ "$who" = P ]; then dir=$parent; else dir=$change; fi
  log=$PWD/chiprun_out/pairs/${i}_${who}.log
  (cd "$dir" && python3 chip_smoke.py > "$log" 2>&1); rc=$?
  echo "== run $i $who rc=$rc"
  grep -E "^kernel B=5 T= 2048|^kernel B=6 T= 3584|^flash dropout B=6 T= 3584|^  fwd  |^fwd per|^forward as training runs it, per|^backward as training runs it, per|^serve [01]:|^int8(-static|-tail)? serve [01]:|^profile of one|^profile: wall|^training reading|^int8 conv (per|stage|fixed)|^GEMM \(M, K, N\) = \(8192|^GEMM int8 B\^T|^  part 1|^fused MRF per serve|^fused serve|^profile: row 6|^kernels against plain attention|^kernel loss and gradients|^fused MRF bf16 per serve|^fused MRF bf16 C=|^ptxas mrf_kernel_bf16|^row 6 bf16|^bench batch .* (float32|bfloat16) (fused|int8)" "$log" | cut -c1-300
done
