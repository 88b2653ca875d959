"""Bounds for the kernels: the least time an H100 could take for their work.

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the card's published
memory rate, and the operations it does on these inputs over the card's
published rate for their type (``bound_ms``).  For the render kernels the
work depends on the data, so the operations are counted per path segment,
per continuing segment, per item and, for the replay, per non-zero term of
its accumulation, from the expression chains of ``csrc/step_math.cuh`` and
``csrc/replay.cu`` (``segment_ops`` and friends), and multiplied by what a
run measured.  The same counts times the per-op times that
``scripts/torch_perf_probe.py`` measures give the probe-model time
(``probe_model_ms``): what the card's own measured rates allow, without
divergence or idle threads.  ``CHAIN_OPS`` counts one application of each
probe op chain by the same rule.  ``sass_loops`` reads which instructions
a kernel's loop holds from ``cuobjdump -sass`` output.

Counting rule: every float or integer add, subtract, multiply, compare,
select, conversion, shift and xor written in the source is one ``simple``
operation; a square root, a division and a sine or cosine are one
operation of their own class; a 13-round Threefry-2x32 block is 42 simple
operations (13 rounds of add, rotate, xor, and 3 for the key schedule: the
rest of it folds into three-input adds and xors, as the SASS of the
probe's Threefry loop shows).  The published-peak bound charges every
operation one issue, which is a floor: a precise square root or division
takes several.
"""

from __future__ import annotations

import re
from typing import NamedTuple

# NVIDIA's data sheet for the H100 SXM at its 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
# 67 TFLOP/s float32 outside the tensor cores, counted as 2 flops per fused
# multiply-add: 132 SMs x 128 lanes x 1.98 GHz issues a second.
PEAK_FP32_ISSUES_PER_S = 33.5e12
THREEFRY_BLOCK_OPS = 42


class OpCounts(NamedTuple):
    """Operations of one unit of work, by class."""

    simple: int = 0
    threefry: int = 0  # 13-round blocks
    sqrt: int = 0
    div: int = 0
    sincos: int = 0

    def issues(self) -> int:
        """Every operation charged one issue (a Threefry block 42)."""
        return (self.simple + THREEFRY_BLOCK_OPS * self.threefry + self.sqrt + self.div
                + self.sincos)

    def plus(self, other: "OpCounts") -> "OpCounts":
        return OpCounts(*(a + b for a, b in zip(self, other)))

    def times(self, n: int) -> "OpCounts":
        return OpCounts(*(n * a for a in self))


def segment_ops(n_spheres: int) -> OpCounts:
    """What every path segment does in ``pt::bounce``: one Threefry block
    and two uniforms (1 + 6; the second block belongs to the diffuse
    sampler, which the least continuing segment does not run), the ray's
    squared length and its reciprocal (5, one division), and per sphere the
    anchor-point quadratic and its root choice (``pt::hit_sphere``: 48, one
    square root, one division)."""
    return OpCounts(simple=12 + 48 * n_spheres, threefry=1, sqrt=n_spheres,
                    div=n_spheres + 1)


def continue_ops() -> OpCounts:
    """What a segment that goes on to another adds at the least: the hit
    record, the emission pickup, the roulette test, the cheapest sampler
    (specular reflection) and the state update."""
    return OpCounts(simple=64, sqrt=1, div=1)


def item_ops() -> OpCounts:
    """``pt::start_path``, once per item: the item's cell, sample, pixel and
    subpixel by four integer divisions, each with a multiply and a subtract
    for its remainder, the clamp and two adds (4 divisions, 11); the item
    key and the lens pair (two blocks, four uniforms: 12); four conversions,
    the cell's screen position (10) and the thin-lens ray (41, one square
    root, a sine and a cosine).  How a kernel hands items to its threads
    (a queue, a stride, a lane's rank among the idle) is its design's own
    and is not charged."""
    return OpCounts(simple=78, threefry=2, sqrt=1, div=4, sincos=2)


def replay_segment_ops() -> OpCounts:
    """What the replay adds to every segment: the cotangent times the
    throughput and the pickup, and their sum (8), and the emission or
    background partial (3)."""
    return OpCounts(simple=11)


def replay_prefix_term_ops() -> OpCounts:
    """One non-zero ``cnt * q`` term: a sphere the path has hit and continued
    from adds four products to its four partials (8).  A sphere whose
    counter is zero adds ``0 * q`` and is not charged."""
    return OpCounts(simple=8)


def replay_continue_ops() -> OpCounts:
    """A continuing segment counts its sphere (the roulette counter only
    after a roulette: the least is 1)."""
    return OpCounts(simple=1)


def render_ops(n_spheres: int, segments: int, n_items: int, *,
               replay_prefix_terms: int | None = None) -> OpCounts:
    """The operations of a render of ``n_items`` paths that took
    ``segments`` segments in all (each path's last segment does not go on).
    With ``replay_prefix_terms``, the replay kernel's accumulation as well:
    the count of (segment, sphere) pairs with a non-zero prefix counter that
    the plain replay measured on this data (``ops/replay.replay_items``)."""
    per_segment, per_continue = segment_ops(n_spheres), continue_ops()
    extra = OpCounts()
    if replay_prefix_terms is not None:
        per_segment = per_segment.plus(replay_segment_ops())
        per_continue = per_continue.plus(replay_continue_ops())
        extra = replay_prefix_term_ops().times(replay_prefix_terms)
    return (per_segment.times(segments).plus(per_continue.times(segments - n_items))
            .plus(item_ops().times(n_items)).plus(extra))


# One application of each op chain of ``ops/kernels/probe.py``, by the
# counting rule above and without the loop's own control instructions: the
# multiply-add as this package compiles it (two) and as the fused
# instruction (one); sqrt(x + b); 1 / sqrt(x + b); compare, multiply, add,
# select; add, rotate, xor; a Threefry block with the xors and the add that
# make its inputs and fold its outputs.
CHAIN_OPS = {
    "mul_add": OpCounts(simple=2),
    "fma": OpCounts(simple=1),
    "add": OpCounts(simple=1),
    "sin": OpCounts(sincos=1),
    "sqrt": OpCounts(simple=1, sqrt=1),
    "rsqrt": OpCounts(simple=1, sqrt=1, div=1),
    "select": OpCounts(simple=4),
    "u32_round": OpCounts(simple=3),
    "threefry": OpCounts(simple=3, threefry=1),
}


def geometry_sweep_ops() -> OpCounts:
    """One bounce of the geometry replay's sweep (``bounce_vjp`` in
    ``csrc/geometry_replay.cu``) at the least: the hit sphere's quadratic
    and root choice again (58, a square root, two divisions), the hit
    record again (29, a square root, a division), the bounce's first
    Threefry block and its uniform (2), the cheapest sampler's VJP
    (specular reflection, 27), the normal's fold and the hit record's VJP
    (37), the root's VJP and the sphere's four partials (75, three
    divisions)."""
    return OpCounts(simple=228, threefry=1, sqrt=2, div=6)


def geometry_path_ops() -> OpCounts:
    """What a path that ends on a miss adds once: the seed (the cotangent's
    weight and d(sky_t)/d(d): 20, a square root, a division), the item's
    camera sample again (``item_ops`` less the ray: 40, two blocks, four
    divisions) and the primary ray's VJP with its 14 partials (45, a square
    root, a sine and a cosine)."""
    return OpCounts(simple=105, threefry=2, sqrt=2, div=5, sincos=2)


def geometry_tie_ops() -> OpCounts:
    """What a swept bounce whose root tied adds at the least: one more
    sphere (m >= 2 tie; the kernel's count does not carry m) takes a share
    of t's adjoint (a division), its root again (``pt::hit_sphere``'s
    quadratic and root choice, as ``segment_ops`` counts it: 48, a square
    root, a division) and its root's VJP with its partials (75, three
    divisions).  Which spheres tie the forward's intersect already found;
    the kernel's recompute of every other sphere's root is its own cost,
    not the function's."""
    return OpCounts(simple=123, sqrt=1, div=5)


def geometry_ops(n_spheres: int, segments: int, n_items: int, sweep_bounces: int,
                 missed: int, tied_bounces: int = 0) -> OpCounts:
    """The geometry replay kernel's operations: the forward render's
    (``render_ops``) and the sweeps that this run's data needed: the
    bounces swept back, the paths that ended on a miss and the swept
    bounces whose root tied."""
    return (render_ops(n_spheres, segments, n_items)
            .plus(geometry_sweep_ops().times(sweep_bounces))
            .plus(geometry_path_ops().times(missed))
            .plus(geometry_tie_ops().times(tied_bounces)))


def geometry_record_bytes(segments: int, sweep_bounces: int, paths: int) -> int:
    """The geometry replay's record traffic: one 32-byte sector (8 words)
    stored a segment, of which a path's last segment, never swept, stores
    its first 16 bytes only, and loaded a bounce swept back."""
    return 32 * (segments + sweep_bounces) - 16 * paths


def bound_ms(nbytes: float, issues: float) -> tuple[float, str]:
    """(least ms, which side binds) for moving ``nbytes`` and issuing
    ``issues`` operations at the published peaks."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = issues / PEAK_FP32_ISSUES_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def lane_state_bytes(lanes: int, launches: int, carried_in: int, carried_out: int,
                     words_changed: int, n_items: int) -> int:
    """Device-memory bytes the per-step kernel's design moves in a render,
    from what a run counted: every lane reads its gen and alive words each
    launch (8); a lane alive when a launch starts reads its path, 12 floats
    and 3 ints (60), one alive when it ends writes it (60); a gen or alive
    word that changed is written (4); each item writes its radiance (12).
    The floor of the state traffic is this over the memory rate."""
    return (8 * lanes * launches + 60 * (carried_in + carried_out) + 4 * words_changed
            + 12 * n_items)


def probe_model_ms(ops: OpCounts, constants: dict) -> float:
    """``ops`` at the rates a probe measured (``scripts/torch_perf_probe.py``
    keys, in G/s): a simple operation at the add chain's rate; a square
    root at the sqrt chain's time less its add; a division at the 1/sqrt
    chain's time less the sqrt chain's; a sine or cosine at the sin
    chain's; a Threefry block at the cipher's rate."""
    t_simple = 1.0 / constants["f32_add_gops"]
    t_sqrt = 1.0 / constants["sqrt_gops"] - t_simple
    t_div = 1.0 / constants["rsqrt_gops"] - 1.0 / constants["sqrt_gops"]
    t_sin = 1.0 / constants["sin_gops"]
    t_block = 1.0 / constants["threefry2x32_gblocks_per_s"]
    ns = (ops.simple * t_simple + ops.sqrt * t_sqrt + ops.div * t_div + ops.sincos * t_sin
          + ops.threefry * t_block)
    return ns / 1e6


# Per-SM-per-clock rates of an H100 (compute capability 9.0, the CUDA C++
# Programming Guide's arithmetic instruction throughput table) by the pipe an
# opcode issues to: "fma", float32 add, multiply and FMA, 128; "imad", the
# 32-bit integer multiply-adds (IMAD, and VIADD, an add the compiler issues
# there), 64, and they take the fma pipe's slots too; "alu", 32-bit integer
# add, shift, logic, compare, select and move (float compare, select and
# min/max with them), 64; "xu", MUFU and type conversions, 16.  Every
# instruction, a branch, a barrier or a uniform-datapath one too, also takes
# a dispatch slot of the SM's four schedulers, 128 lanes a clock.
PIPE_RATES = {"fma": 128, "imad": 64, "alu": 64, "xu": 16, "dispatch": 128}
SM_CLOCK_HZ = 1.98e9  # under load (PERF.md section 6)
N_SMS = 132
_PIPES = {
    "fma": {"FADD", "FMUL", "FFMA", "FADD32I", "FMUL32I", "FFMA32I", "FSWZADD"},
    "imad": {"IMAD", "IMUL", "VIADD"},
    "alu": {"IADD3", "IADD", "IADD32I", "LOP3", "LOP", "LOP32I", "SHF", "SHL", "SHR", "LEA",
            "ISCADD", "ISETP", "FSETP", "FSEL", "SEL", "FMNMX", "IMNMX", "MOV", "MOV32I", "PRMT",
            "IABS", "PLOP3", "BMSK", "FCHK"},
    "xu": {"MUFU", "F2I", "I2F", "F2F", "I2I", "I2FP", "F2IP", "FRND", "F2FP", "POPC", "FLO",
           "BREV"},
}


def pipe_bound_ms(pipes: dict, trips: float) -> tuple[float, str]:
    """(least ms, the pipe that binds) of ``trips`` thread-trips of a loop
    whose trip issues ``pipes`` instructions by pipe (``sass_loops``'
    ``fast_path``), each pipe at its rate over 132 SMs at 1,980 MHz."""
    times = {p: trips * n / (PIPE_RATES[p] * N_SMS * SM_CLOCK_HZ) * 1e3
             for p, n in pipes.items() if p in PIPE_RATES}
    pipe = max(times, key=times.get)
    return times[pipe], pipe


def _fast_path(code: list, first: int, last: int) -> dict:
    """The instructions one trip of the loop ``code[first..last]`` issues
    when every forward branch inside it is taken: the blocks such a branch
    skips (a precise square root's or division's slow path, compiled in
    line) are left out.  By pipe (``PIPE_RATES``; an IMAD counts on the fma
    pipe too) and by opcode (a CALL among them would be a slow path the
    walk did not skip)."""
    index = {addr: i for i, (addr, _, _, _) in enumerate(code)}
    pipes = dict.fromkeys(PIPE_RATES, 0)
    opcodes, i = {}, first
    while i <= last:
        addr, _, op, rest = code[i]
        base = op.split(".")[0]
        opcodes[base] = opcodes.get(base, 0) + 1
        pipes["dispatch"] += 1
        pipe = next((p for p, ops in _PIPES.items() if base in ops), None)
        if pipe:
            pipes[pipe] += 1
            pipes["fma"] += pipe == "imad"
        target = re.search(r"0x([0-9a-f]+)", rest) if base == "BRA" and i < last else None
        if target and addr < int(target.group(1), 16) and index.get(
                int(target.group(1), 16), last + 1) <= last:
            i = index[int(target.group(1), 16)]
            continue
        i += 1
    return {"instructions": pipes["dispatch"], "pipes": pipes, "opcodes": opcodes}


_INSTRUCTION = re.compile(
    r"^\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")


def kernel_label(mangled: str) -> str:
    """``replay_kernel<u32,8>`` from a mangled entry name: the ``*_kernel``
    function (found by its length prefix, which may follow the hex digits
    of an anonymous namespace's name) and its template arguments: integers,
    and the index types ``u32`` (unsigned int) and ``i64`` (long long)."""
    types = {"j": "u32", "x": "i64"}
    for run in re.finditer(r"\d+", mangled):
        for start in range(run.start(), run.end()):
            name = mangled[run.end():run.end() + int(mangled[start:run.end()])]
            if name.endswith("_kernel") and re.fullmatch(r"[a-z][a-z0-9_]*", name):
                args = re.match(r"I((?:[jx]|Li\d+E)+)E", mangled[run.end() + len(name):])
                found = re.findall(r"[jx]|Li\d+E", args.group(1)) if args else []
                labels = [types[a] if a in types else a[2:-1] for a in found]
                return name + (f"<{','.join(labels)}>" if labels else "")
    return mangled


def sass_loops(sass: str) -> dict:
    """Per kernel of a ``cuobjdump -sass`` listing, its widest loop: the
    instructions from the target of a backward branch to that branch,
    ``{label: {"instructions": n, "opcodes": {opcode: count}}}`` with the
    opcode's first part as key (``FMUL``, ``MUFU``).  The span also holds
    what a forward branch skips at run time (a slow path compiled in line),
    so it shows that an instruction is in the loop, not how many issue on a
    trip; ``fast_path`` (``_fast_path``) counts those.  A kernel without a
    backward branch is left out."""
    out, label, code = {}, None, []

    def close():
        if label is None:
            return
        index = {addr: i for i, (addr, _, _, _) in enumerate(code)}
        best = None
        for i, (addr, _, op, rest) in enumerate(code):
            target = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
            if target and int(target.group(1), 16) <= addr and int(target.group(1), 16) in index:
                span = (index[int(target.group(1), 16)], i)
                if best is None or span[1] - span[0] > best[1] - best[0]:
                    best = span
        if best is not None:
            ops = {}
            for _, _, op, _ in code[best[0]:best[1] + 1]:
                ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
            out[label] = {"instructions": best[1] - best[0] + 1, "opcodes": ops,
                          "fast_path": _fast_path(code, *best)}

    for line in sass.splitlines():
        if "Function :" in line:
            close()
            label, code = kernel_label(line.split("Function :")[1].strip()), []
            continue
        m = _INSTRUCTION.match(line)
        if m and label is not None:
            code.append((int(m.group(1), 16), bool(m.group(2)), m.group(3), m.group(4)))
    close()
    return out
