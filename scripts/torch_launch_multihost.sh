#!/usr/bin/env bash
# Launch an N-process render of the PyTorch port locally: N ranks of
# `cli render --num-processes N`, joined over a TCP rendezvous on this host
# (gloo).  On the card the ranks take cuda:{rank % cards}; pass --device cpu
# to run on the CPU.  On several hosts, run one rank on each with the same
# --coordinator HOST0:PORT and its own --process-id.
#
# Usage: scripts/torch_launch_multihost.sh [NPROCS] [extra render args...]
set -euo pipefail

NPROCS="${1:-2}"
shift $(( $# >= 1 ? 1 : 0 )) || true
PORT="${PT_COORD_PORT:-$((20000 + RANDOM % 20000))}"
OUT="${PT_OUT:-pt_multihost}"
mkdir -p "$OUT"

pids=()
for (( p=0; p<NPROCS; p++ )); do
    python -m cpu_path_tracing_tpu_torch.cli render \
        --coordinator "127.0.0.1:$PORT" --num-processes "$NPROCS" --process-id "$p" \
        -o "$OUT/image.png" "$@" &
    pids+=($!)
done
rc=0
for pid in "${pids[@]}"; do wait "$pid" || rc=$?; done
exit $rc
