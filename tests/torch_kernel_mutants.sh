#!/usr/bin/env bash
# Mutation check of chip_smoke.py's kernel checks (its phase 2), for a machine
# with a CUDA card and nvcc. Run from the repository root:
#
#     bash tests/torch_kernel_mutants.sh
#
# It makes four copies of the port in a temporary directory, each with one
# kernel deliberately broken in its CUDA source (a query tile dropped from the
# column sums, a key tile dropped from the row logsumexp, the tail and one
# prefix step dropped from the head-wise decode), and runs
# chip_smoke.kernel_checks in each. Every copy must be rejected; the script
# exits 1 if one passes or if a mutation did not apply.
set -u
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
status=0
for m in colsum_query_tile lse_key_tile headwise_tail headwise_prefix_step; do
  d=$(mktemp -d)/$m
  mkdir -p "$d"
  cp -r kvpress_tpu_torch tests chip_smoke.py "$d"/
  oc=$d/kvpress_tpu_torch/csrc/observed_colsum.cu
  hw=$d/kvpress_tpu_torch/csrc/decode_headwise.cu
  case $m in
    colsum_query_tile)
      sed -i 's/const bool ok = !edge || (kslot <= qslot \&\& qslot < p.S);/const bool ok = (!edge || (kslot <= qslot \&\& qslot < p.S)) \&\& qt != nq - 2;/' "$oc" ;;
    lse_key_tile)
      sed -i 's/sc\[n\]\[i\] = (kslot <= qslot \&\& kslot < p.S) ? x : NEG_INF;/sc[n][i] = (kslot <= qslot \&\& kslot < p.S \&\& s != 8) ? x : NEG_INF;/' "$oc" ;;
    headwise_tail)
      sed -i 's/const int n_tail = tail_end > tail_lo ? (tail_end - tail_lo + NK - 1) \/ NK : 0;/const int n_tail = 0;/' "$hw" ;;
    headwise_prefix_step)
      sed -i 's/pref ? prefix_len : tail_end, 0,/s == 4 ? 0 : (pref ? prefix_len : tail_end), 0,/' "$hw" ;;
  esac
  changed=$(diff -r kvpress_tpu_torch/csrc "$d/kvpress_tpu_torch/csrc" | grep -c '^>')
  echo "== mutant $m: $changed changed line(s)"
  if [ "$changed" != 1 ]; then status=1; continue; fi
  (cd "$d" && python3 - <<'PY' 2>&1 | tail -n 2
import sys, torch
sys.path.insert(0, "."); sys.path.insert(0, "tests")
import chip_smoke, kvpress_tpu_torch as kt
try:
    chip_smoke.kernel_checks(kt, torch, lambda m: None)
except AssertionError as e:
    print("REJECTED:", str(e)[:300])
else:
    print("PASSED THE CHECKS")
PY
  ) | tee "$d.out"
  grep -q '^REJECTED:' "$d.out" || status=1
done
exit $status
