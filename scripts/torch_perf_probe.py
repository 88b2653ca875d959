#!/usr/bin/env python3
"""Measured machine constants of one NVIDIA GPU for the PERF.md bounds.

The PyTorch + CUDA twin of ``scripts/perf_probe.py``: it measures, on the
attached card, the rates the port's kernels are judged against, with the
hand-written probe kernels of ``cpu_path_tracing_tpu_torch/csrc/probe.cu``
(``ops/kernels/probe.op_chain`` and ``stream_scale``):

  * float32 multiply-add throughput, as the fused instruction and as the
    multiply and add the package's ``-fmad=false`` build issues
  * float32 add, sin, sqrt, 1/sqrt and compare-select throughput
  * uint32 ALU throughput (the add/rotl/xor mix of one Threefry round)
  * threefry2x32 blocks/s (the production cipher, ops/rng.py)
  * device-memory stream bandwidth (read + write of a large f32 array),
    through one PyTorch call and through the stream kernel

Usage: python3 scripts/torch_perf_probe.py [--json out.json]

Prints one JSON line.  Its keys, and the ``perf_probe.py`` key each answers
to (the ``vpu_`` and ``hbm_`` words name TPU parts and are dropped):

  f32_fma_gops, f32_fma_gflops   vpu_f32_fma_gops, vpu_f32_fma_gflops (the
                                 fused instruction, ``__fmaf_rn``)
  f32_mul_add_gops               the same JAX body ``x * a + b`` as this
                                 package compiles it: a multiply and an add
  f32_add_gops                   vpu_f32_add_gops
  sin_gops, sqrt_gops, rsqrt_gops, select_chain_gops
                                 vpu_sin_gops, vpu_sqrt_gops, vpu_rsqrt_gops,
                                 vpu_select_chain_gops
  u32_round_mix_gops             vpu_u32_round_mix_gops (and its duplicate
                                 vpu_u32_round_mix_g_rounds)
  threefry2x32_gblocks_per_s     threefry2x32_gblocks_per_s
  mem_stream_gbps                hbm_stream_gbps (``torch.add(x, 1.0)``, a
                                 PyTorch call as JAX's was an XLA op)
  mem_kernel_stream_gbps         hbm_pallas_stream_gbps (the stream kernel)

and beside them ``ms`` (one launch of each), ``issues_per_op`` (what one
application of each chain is charged by the counting rule of
``utils/roofline.py``: a multiply-add pair two, 1/sqrt(x + b) three, a
Threefry block with its xors 45, no loop control), ``share_of_peak``
(each rate times those issues against the card's published 33.5 T
float32 issues/s, and each stream against 3.35 TB/s; the rule charges a
precise sine, square root or division one issue where the card takes
many, so their shares are small by construction), the SM clock read
while the fma chain runs, and nvidia-smi's name and power limit.

Every op chain runs at ``FULL_N`` elements (four waves of 132 SMs x 2,048
resident threads), 8 chains per thread (2 for Threefry) and the iteration
counts of ``perf_probe.py``; the streams at 2^26 float32 (256 MiB in, 256
MiB out, past the 50 MB L2, so every launch finds it cold).  Times are
CUDA events around ``REPS`` launches after a warm-up.  The sin chain's
values stay in (0, 1], off sinf's slow range reduction.

Imports nothing of JAX.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from cpu_path_tracing_tpu_torch.ops.kernels import probe as pk  # noqa: E402
from cpu_path_tracing_tpu_torch.utils import roofline  # noqa: E402

FULL_N = 132 * 2048 * 4
STREAM_N = 1 << 26
REPS = 20
# The key of each op's rate.
RATE_KEYS = {"fma": "f32_fma_gops", "mul_add": "f32_mul_add_gops", "add": "f32_add_gops",
             "sin": "sin_gops", "sqrt": "sqrt_gops", "rsqrt": "rsqrt_gops",
             "select": "select_chain_gops", "u32_round": "u32_round_mix_gops",
             "threefry": "threefry2x32_gblocks_per_s"}


def n_arrays(op: str) -> int:
    return 2 if op == "threefry" else 8


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """CUDA-event ms per call of ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def chain_inputs(op: str, n: int, device) -> torch.Tensor:
    """The inputs of ``perf_probe.py``: row a is 1 + 1e-7 a in float32, or
    the word 12345 + a (as the int32 the kernel stores)."""
    rows = torch.arange(n_arrays(op), device=device)
    if pk.OPS[op].words:
        return (12345 + rows).to(torch.int32)[:, None].expand(-1, n).contiguous()
    return (1.0 + 1e-7 * rows.double()).float()[:, None].expand(-1, n).contiguous()


def probe() -> dict:
    """Measure every constant on the current CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probe measures a CUDA device and there is none")
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"device": torch.cuda.get_device_name(dev),
           "nvidia_smi": smi("name,power.limit"), "n": FULL_N, "stream_n": STREAM_N,
           "reps": REPS}
    ms, share = {}, {}
    issues = {op: roofline.CHAIN_OPS[op].issues() for op in RATE_KEYS}
    for op, key in RATE_KEYS.items():
        xs, iters = chain_inputs(op, FULL_N, dev), pk.OPS[op].iters
        ms[op] = time_ms(lambda: pk.op_chain(xs, op, iters), REPS)
        rate = xs.numel() * iters / (ms[op] / 1e3)
        out[key] = rate / 1e9
        share[key] = rate * issues[op] / roofline.PEAK_FP32_ISSUES_PER_S
        if op == "fma":
            out["f32_fma_gflops"] = 2 * rate / 1e9
            # The SM clock while the card is busy: a second of launches in
            # flight behind the query.
            for _ in range(max(1, int(1000 / ms[op]))):
                pk.op_chain(xs, op, iters)
            out["sm_clock_mhz"] = smi("clocks.sm")
            torch.cuda.synchronize()
    out["sm_clock_max_mhz"] = smi("clocks.max.sm")

    x = torch.arange(STREAM_N, dtype=torch.float32, device=dev)
    nbytes = 2 * 4 * STREAM_N
    for key, name, fn in (("mem_stream_gbps", "torch_add", lambda: torch.add(x, 1.0)),
                          ("mem_kernel_stream_gbps", "stream_scale",
                           lambda: pk.stream_scale(x))):
        ms[name] = time_ms(fn, REPS // 2)
        out[key] = nbytes / (ms[name] / 1e3) / 1e9
        share[key] = out[key] * 1e9 / roofline.PEAK_BYTES_PER_S
    out["ms"], out["share_of_peak"], out["issues_per_op"] = ms, share, issues
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None, help="also write the line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    line = json.dumps(probe())
    print(line)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
