#!/usr/bin/env bash
# Mutation check of chip_smoke.py's kernel checks (its phase 2), for a machine
# with a CUDA card and nvcc. Run from the repository root:
#
#     bash tests/torch_kernel_mutants.sh
#
# It makes thirty-four copies of the port in a temporary directory, each with one
# kernel deliberately broken in its CUDA source (in the column sums a query
# stage dropped and every stage taken without the causal test, a key tile
# dropped from the row logsumexp; in the head-wise decode the tail, one
# prefix step and one chunk of every head dropped; in the decode one live
# step taken for dead, one key range dropped and the window's test dropped
# from the step across its edge; in the decode kernels' merge one range
# given no weight; in the flash main loop a diagonal tile's
# causal test dropped, every tile taken for all-live, and the first key range
# dropped from the merge of a split launch; in the flash or-mask the key range
# not widened past the diagonal, not widened behind the window, and the
# gq >= 0 guard dropped; and three that only the head_dim-256 instantiations
# can show: the flash producer copying the first pair of panels' channels
# into the second, a decode consumer reading one 16-byte K chunk of a lane's
# quarter row in place of another, the column sums' producer copying the
# first pair of query panels into the second; and three that only the
# head_dim-96 instantiations can show: a k16 step dropped from the flash
# kernel's S = Q.K^T, the last 8 bytes of a decode lane's 24-byte value
# run (or int8 key run) not loaded, the column sums' S^T cut short by a k16
# step), and runs
# chip_smoke.kernel_checks in each. The
# or-mask copies must also fail the or-mask card tests
# (tests/test_torch_kernels_card.py -k or_mask). Two more copies break the
# runner and the pipeline, not a kernel: bucketed prefill hands the press the
# bucket's length in place of the valid length (runner_bucket_len), and
# chip_smoke.bucketed_check runs in it; the pipeline leaves the offset at the
# context's length after a rerotating press (pipeline_rerotation_offset), and
# chip_smoke.rerotation_check runs in it. Two more break this slice's modules:
# cache.compact_masked counts the slots at or past a layer's length among the
# kept ones (compact_masked_past_length), and chip_smoke.compact_masked_check
# runs in it; the Duo split decode gathers the heads back through a reversed
# inverse permutation (duo_inverse_permutation), and chip_smoke.duo_split_check
# runs in it. Two more break the multi-pass presses: KVzip's lean repeat pass
# advances the cache's length and offset as a chunk forward does
# (kvzip_pass_writes_context), and chip_smoke.kvzip_context_check runs in it;
# KVCompose's structured rebuild
# gathers the kept entries in score order instead of position order
# (kvcompose_rebuild_order), and chip_smoke.kvcompose_rebuild_check runs in it.
# Four more break the serving engine, and chip_smoke.serving_check (the
# serving phase's S1 with its checks) runs in each: the slot step appends at
# each slot's length + 1 (serving_append_late), an admission's cache goes into
# the next slot (serving_insert_slot), dead lanes advance their lengths
# (serving_dead_lane_advance), and an admission writes its first token into
# the tokens tensor a pending step holds (serving_tokens_in_place); the CPU
# serving tests (tests/test_torch_serving*.py) fail on each too. One more
# breaks tensor parallelism: a layer drops its all-reduce over "model" after
# wd (tp_mlp_all_reduce), and chip_smoke.tp_serving_check (the model 2 world
# over gloo on the one card) runs in it; tests/test_torch_parallel.py and
# tests/test_torch_serving_parallel.py fail on it too. One more breaks context
# parallelism: the ring combines each block with weight 1 in place of
# exp(lse_blk - lse_new) (cp_ring_block_weight), and chip_smoke.cp_check (the
# seq 4 world over gloo on the one card) runs in it;
# tests/test_torch_context_prefill.py fails on it too. One more breaks the
# KVzap collector: its targets drop the ||Wo . v|| factor
# (kvzap_collector_wov), and chip_smoke.kvzap_check (the collector at the
# flagship's width, held against its float64 recomputation) runs in it;
# tests/test_torch_training.py fails on it too.
# Every copy must be rejected; the script exits 1 if one passes or if a
# mutation did not apply. Mutant names given as arguments run those alone.
set -u
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
status=0
mutants="colsum_query_tile colsum_diagonal lse_key_tile headwise_tail headwise_prefix_step
         headwise_chunk decode_live_step decode_split_range decode_window_edge decode_merge_range
         flash_diagonal_tile flash_all_live flash_merge_range
         or_upper_range or_lower_range or_text_guard
         flash_d256_panels decode_d256_key_chunk colsum_d256_panels
         flash_d96_k_step decode_d96_tail_words colsum_d96_k_step runner_bucket_len
         pipeline_rerotation_offset compact_masked_past_length duo_inverse_permutation
         kvzip_pass_writes_context kvcompose_rebuild_order serving_append_late
         serving_insert_slot serving_dead_lane_advance serving_tokens_in_place
         tp_mlp_all_reduce cp_ring_block_weight kvzap_collector_wov"
for m in ${@:-$mutants}; do
  d=$(mktemp -d)/$m
  mkdir -p "$d"
  cp -r kvpress_tpu_torch tests chip_smoke.py "$d"/
  oc=$d/kvpress_tpu_torch/csrc/observed_colsum.cu
  hw=$d/kvpress_tpu_torch/csrc/decode_headwise.cu
  dc=$d/kvpress_tpu_torch/csrc/decode.cu
  dm=$d/kvpress_tpu_torch/csrc/decode_sm90.cuh
  fl=$d/kvpress_tpu_torch/csrc/flash_sm90.cuh
  rn=$d/kvpress_tpu_torch/models/llama.py
  pl=$d/kvpress_tpu_torch/pipeline.py
  ca=$d/kvpress_tpu_torch/cache.py
  du=$d/kvpress_tpu_torch/ops/duo_decode.py
  sv=$d/kvpress_tpu_torch/serving.py
  rg=$d/kvpress_tpu_torch/parallel/ring.py
  kz=$d/kvpress_tpu_torch/training/kvzap.py
  check=kernel_checks
  case $m in
    colsum_query_tile)
      sed -i 's/    if (t0 + BQ - 1 >= kw) {/    if (t0 + BQ - 1 >= kw \&\& n != w.nst - 3) {/' "$oc" ;;
    colsum_diagonal)
      sed -i 's/add(ring.lse(stage), t0, t0 < kw + 63);/add(ring.lse(stage), t0, false);/' "$oc" ;;
    lse_key_tile)
      sed -i 's/      sum\[(e >> 1) \& 1\]\[(e >> 2) \& 3\] += ex2(/      sum[(e >> 1) \& 1][(e >> 2) \& 3] += i == 4 ? 0.f : ex2(/' "$fl" ;;
    headwise_tail)
      sed -i 's/const int n_tail = tail_end > tail_lo ? (tail_end - tail_lo + NK - 1) \/ NK : 0;/const int n_tail = 0;/' "$hw" ;;
    headwise_prefix_step)
      sed -i 's/Step{j \* NK, prefix_len, 0, (j + 1) \* NK <= prefix_len ? DENSE : EDGE}/Step{j * NK, j == 4 ? 4 * NK + 1 : prefix_len, 0, (j + 1) * NK <= prefix_len \&\& j != 4 ? DENSE : EDGE}/' "$hw" ;;
    headwise_chunk)
      sed -i 's/  const int n = min(n_pref + n_tail, i0 + per) - i0;/  const int n = split == 1 ? 0 : min(n_pref + n_tail, i0 + per) - i0;/' "$hw" ;;
    decode_live_step)
      sed -i 's/    if (lane == 0) live\[j\] = any ? 1 + all : 0;/    if (lane == 0) live[j] = any \&\& j != 2 ? 1 + all : 0;/' "$dc" ;;
    decode_split_range)
      sed -i 's/  const int n = min(nst, i0 + per) - i0;/  const int n = split == 1 ? 0 : min(nst, i0 + per) - i0;/' "$dc" ;;
    decode_window_edge)
      sed -i 's/(p.window <= 0 || slot > qs\[r\] - p.window);/true;/' "$dm" ;;
    decode_merge_range)
      sed -i 's/  if (tid < nsplit) wgt\[tid\] = mmax == -INFINITY ? 0.f/  if (tid < nsplit) wgt[tid] = mmax == -INFINITY || tid == 1 ? 0.f/' "$dm" ;;
    flash_diagonal_tile)
      sed -i 's/const bool below_diagonal = key0 + NK - 1 <= qmin;/const bool below_diagonal = true;/' "$fl" ;;
    flash_all_live)
      sed -i 's/const bool all_live = (flags \& ALL_LIVE) != 0u;/const bool all_live = true;/' "$fl" ;;
    flash_merge_range)
      sed -i 's/    for (int s = 0; s < nsplit; ++s) {/    for (int s = 1; s < nsplit; ++s) {/' "$fl" ;;
    or_upper_range)
      sed -i 's/  const int kend = min(p.S, p.prior + last_t + 1 + up);/  const int kend = min(p.S, p.prior + last_t + 1);/' "$fl" ;;
    or_lower_range)
      sed -i 's/  const int back = OR ? max(p.window - 1, up) : p.window - 1;/  const int back = p.window - 1;/' "$fl" ;;
    or_text_guard)
      sed -i 's/in = in || (gq\[e >> 1\] >= 0 \&\& gq\[e >> 1\] ==/in = in || (gq[e >> 1] ==/' "$fl" ;;
    flash_d256_panels)
      sed -i 's/it \* RPI \* ROW + h \* CPT \* 16 : 0;/it * RPI * ROW : 0;/' "$fl" ;;
    decode_d256_key_chunk)
      sed -i 's/load_words<KC>(kw, kr + kc \* KC \* 4);/load_words<KC>(kw, kr + (kc \& 1) * KC * 4);/' "$dm" ;;
    colsum_d256_panels)
      sed -i 's/ \* D + h \* CPT \* 8, in);/ * D, in);/' "$oc" ;;
    flash_d96_k_step)
      sed -i '/auto start_s = /,/wgmma_commit/ s/kk < D \/ 16; ++kk/kk < D \/ 16 - (D == 96); ++kk/' "$fl" ;;
    decode_d96_tail_words)
      sed -i 's/const uint2 x = reinterpret_cast<const uint2\*>(p)\[j\];/const uint2 x = N > 2 \&\& j == N \/ 2 - 1 ? make_uint2(0u, 0u) : reinterpret_cast<const uint2*>(p)[j];/' "$dm" ;;
    colsum_d96_k_step)
      sed -i 's/for (int kk = 0; kk < D \/ 16; ++kk) {/for (int kk = 0; kk < D \/ 16 - (D == 96); ++kk) {/' "$oc" ;;
    runner_bucket_len)
      sed -i 's/kv_len=valid_len if phase == "prefill" else None,/kv_len=T if valid_len is not None and phase == "prefill" else None,/' "$rn"
      check=bucketed_check ;;
    pipeline_rerotation_offset)
      sed -i 's/offset=torch.tensor(compressed, dtype=torch.int32))/offset=torch.tensor(context_length, dtype=torch.int32))/' "$pl"
      check=rerotation_check ;;
    compact_masked_past_length)
      sed -i 's/        keep = cache.mask\[l\] & (pos < int(cache.length\[l\]))          # (B, H, S)/        keep = cache.mask[l]/' "$ca"
      check=compact_masked_check ;;
    duo_inverse_permutation)
      sed -i 's/        o = o\[:, ds.inv_idx\[l\]\].reshape(B, Hkv \* G, 1, D)/        o = o[:, ds.inv_idx[l].flip(0)].reshape(B, Hkv * G, 1, D)/' "$du"
      check=duo_split_check ;;
    kvzip_pass_writes_context)
      sed -i 's/        if kvzip_spec is None:/        if True:/' "$rn"
      check=kvzip_context_check ;;
    kvcompose_rebuild_order)
      sed -i 's/            order = torch.argsort((~keep_buf\[l\]).to(torch.int8), dim=-1, stable=True)/            order = torch.argsort((~keep_buf[l]).float() * 2 - torch.nn.functional.pad(torch.from_numpy(scores[l]).to(self.device), (0, cache.max_size - ctx_len)).clamp(0, 1), dim=-1, stable=True)/' "$pl"
      check=kvcompose_rebuild_check ;;
    serving_append_late)
      sed -i 's/            rows, at = lanes, lengths_dev\[l\]$/            rows, at = lanes, lengths_dev[l] + 1/' "$sv"
      check=serving_check ;;
    serving_insert_slot)
      sed -i 's/        self.sc = _insert_slot(self.sc, cache, slot, self.own)/        self.sc = _insert_slot(self.sc, cache, (slot + 1) % self.n_slots, self.own)/' "$sv"
      check=serving_check ;;
    serving_dead_lane_advance)
      sed -i 's/        lengths\[l\] = torch.where(live, lengths\[l\] + 1, lengths\[l\])/        lengths[l] = lengths[l] + 1/' "$sv"
      check=serving_check ;;
    serving_tokens_in_place)
      sed -i 's/        tokens = self.tokens.clone()/        tokens = self.tokens/' "$sv"
      check=serving_check ;;
    tp_mlp_all_reduce)
      sed -i 's/^        shard.all_reduce(mlp)$/        pass/' "$rn"
      check=tp_serving_check ;;
    cp_ring_block_weight)
      sed -i 's/    w_blk = torch.where(dead, 0.0, torch.exp(lse_blk - lse_new))/    w_blk = torch.where(dead, 0.0, torch.ones_like(lse_new))/' "$rg"
      check=cp_check ;;
    kvzap_collector_wov)
      sed -i 's/        scores = scores \* wov.reshape(B, Hq, 1, -1)$/        scores = scores * 1.0/' "$kz"
      check=kvzap_check ;;
  esac
  changed=$(diff -r kvpress_tpu_torch "$d/kvpress_tpu_torch" | grep -c '^>')
  echo "== mutant $m: $changed changed line(s)"
  if [ "$changed" != 1 ]; then status=1; continue; fi
  (cd "$d" && CHECK=$check python3 - <<'PY' 2>&1 | tail -n 2
import os, sys, torch
sys.path.insert(0, "."); sys.path.insert(0, "tests")
import chip_smoke, kvpress_tpu_torch as kt
from toy_tokenizer import ToyTokenizer
# A copy must be rejected by its readings: time with CUDA events, so that a
# profiler trace that comes back empty cannot reject it.
chip_smoke.kernel_ms = lambda fn, symbol, iters: chip_smoke.cuda_ms(fn, 1, 1)
try:
    if os.environ["CHECK"] in ("bucketed_check", "rerotation_check", "compact_masked_check",
                               "duo_split_check", "kvzip_context_check",
                               "kvcompose_rebuild_check", "serving_check",
                               "tp_serving_check", "cp_check", "kvzap_check"):
        dev = torch.device("cuda")
        params = kt.init_params(chip_smoke.flagship_config(16),
                                torch.Generator(device=dev).manual_seed(0),
                                dtype=torch.bfloat16, device=dev)
        getattr(chip_smoke, os.environ["CHECK"])(kt, torch, ToyTokenizer, params,
                                                 lambda m: None)
    else:
        chip_smoke.kernel_checks(kt, torch, lambda m: None)
except AssertionError as e:
    print("REJECTED:", str(e)[:300])
else:
    print("PASSED THE CHECKS")
PY
  ) | tee "$d.out"
  grep -q '^REJECTED:' "$d.out" || status=1
  case $m in
    or_*)
      if (set -o pipefail; cd "$d" && timeout 900 python -m pytest --noconftest -q -m cuda \
            tests/test_torch_kernels_card.py -k or_mask 2>&1 | tail -n 1); then
        echo "card tests: PASSED THE CHECKS"; status=1
      else
        echo "card tests: REJECTED"
      fi ;;
  esac
done
exit $status
