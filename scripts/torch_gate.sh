#!/usr/bin/env bash
# One-command on-card QA gate of the PyTorch + CUDA port, the twin of
# scripts/tpu_gate.sh: refresh every artifact of the port in one run, so that
# none is committed stale.
#
#   1. scripts/torch_smoke.py  -> TORCH_SMOKE.md        (the parity gate against
#                                 the JAX package's renders; resumable via --state)
#   2. cli bench --suite       -> TORCH_BENCH_SUITE.md  (the production-shape suite)
#   3. scripts/torch_bench.py  -> stdout JSON           (the headline number)
#   4. scripts/lint.py over the port, chip_smoke.py and the smoke
#
# Runs on an NVIDIA GPU (every step defaults to the card).  Exit code 0 only
# if every step is green; a failing step stops the gate.
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== 1/4 torch_smoke (parity) =="
python scripts/torch_smoke.py --state "${TMPDIR:-/tmp}/torch_gate_smoke_state.json"

echo "== 2/4 bench --suite =="
python -m cpu_path_tracing_tpu_torch.cli bench --suite --suite-out TORCH_BENCH_SUITE.md

echo "== 3/4 headline bench =="
python3 scripts/torch_bench.py

echo "== 4/4 lint =="
python scripts/lint.py cpu_path_tracing_tpu_torch chip_smoke.py scripts/torch_smoke.py

echo "torch_gate OK — TORCH_SMOKE.md + TORCH_BENCH_SUITE.md refreshed"
