"""P1: does the card run the SPH pair op mix in bf16 at twice the fp32 rate?

The port's counterpart of `bench/probe_vpu_bf16.py`, which asks it of the
TPU's vector unit to decide whether `precision="bf16"` can pay.  Times a
chain of the SPH inner loop's op mix (sub, mul, add, max), 64 dependent
rounds of

    d = acc - y;  acc = max(d * d + y, acc * 0.5)

over [512, 1024] arrays, with the hand-written CUDA kernels of
`csrc/probe_kernels.cu` (fp32, and bf16 on packed pairs), each launch
feeding the next, the launches replayed as one CUDA graph.

    python -m sph_tpu_torch.probe_vpu_bf16 [iters]

prints, per dtype, the time per call and the op rate, then the bf16 / fp32
throughput ratio, as the TPU probe does, and each dtype's bound.

`probe` launches its kernel for CUDA tensors (building it at first use) or
raises; for CPU tensors it runs the plain version, `chain_plain`, which
rounds each op in its dtype as the kernels do.  `LAUNCHES` counts the
kernel runs: direct launches and the launches of each graph replay, not
those recorded while a graph is captured.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from sph_tpu_torch import _build
from sph_tpu_torch.slot_kernels import _raise_on, _stream

SUB, LANE = 512, 1024          # the arrays: 512x1024 elements
CHAIN = 64                     # dependent op-mix rounds per kernel call
OPS_PER_ROUND = 4              # sub, mul, add, max: the TPU probe's count
#                                for its op rate (the 0.5 multiply is part of
#                                the max's operand there)
INSTR_PER_ROUND = 5            # what the kernels issue a round: sub, mul,
#                                add, mul by 0.5, max — the bound's count
#: arithmetic results per clock per SM for compute capability 9.0 (the CUDA
#: C++ Programming Guide's throughput table: 32-bit floating-point add and
#: multiply 128, 16-bit 256 counting both lanes of a packed pair); the max is
#: counted at the same rate, so the bound is a floor either way
RESULTS_PER_CLOCK = {torch.float32: 128, torch.bfloat16: 256}

#: kernel launches per dtype since the last `reset_launches()`
LAUNCHES = {"probe_f32": 0, "probe_bf16": 0}
_NAMES = {torch.float32: "probe_f32", torch.bfloat16: "probe_bf16"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def chain_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain version of the probe kernels: each op rounds in x's dtype."""
    acc = x
    for _ in range(CHAIN):
        d = acc - y
        acc = torch.maximum(d * d + y, acc * 0.5)
    return acc


def probe(x: torch.Tensor, y: torch.Tensor,
          out: torch.Tensor | None = None) -> torch.Tensor:
    """One call of the probe kernel of x's dtype (fp32 or bf16) → acc, into
    `out` when given."""
    if x.dtype not in _NAMES:
        raise TypeError(f"the probe runs fp32 or bf16, got {x.dtype}")
    for t in (y,) if out is None else (y, out):
        if t.dtype != x.dtype or t.shape != x.shape or t.device != x.device:
            raise ValueError("x, y and out must match in dtype, shape, device")
    if not (x.is_contiguous() and y.is_contiguous()
            and (out is None or out.is_contiguous())):
        raise ValueError("the probe's arrays must be contiguous")
    if x.dtype == torch.bfloat16 and (
            x.numel() % 2 or any(t.data_ptr() % 4 for t in (x, y, out)
                                 if t is not None)):
        raise ValueError("the bf16 kernel takes aligned pairs of elements")
    if x.device.type == "cpu":
        acc = chain_plain(x, y)
        return acc if out is None else out.copy_(acc)
    if out is None:
        out = torch.empty_like(x)
    name = _NAMES[x.dtype]
    lib = _build.library("probe_kernels")
    rc = getattr(lib, name)(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                            x.numel(), x.device.index or 0, _stream(x.device))
    _raise_on(rc, name)
    if not torch.cuda.is_current_stream_capturing():   # a capture runs nothing
        LAUNCHES[name] += 1
    return out


def probe_inputs(dtype, device, seed: int = 0):
    """The TPU probe's own inputs: x ~ N(0, 1), and y = x + 2 in the dtype
    (its PRNG key is drawn twice).  On them every output is inf: the chain
    squares past fp32's range within a few rounds."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((SUB, LANE), generator=gen).to(dtype)
    return x.to(device), (x + 2.0).to(device)


def ops_per_call() -> int:
    return CHAIN * OPS_PER_ROUND * SUB * LANE


def sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def bound_ms(dtype, clock_mhz: float, n_sm: int) -> tuple[float, str]:
    """(least ms a call could take, "operations" or "bytes"): the
    INSTR_PER_ROUND operations of every round and element over
    RESULTS_PER_CLOCK × SMs × clock, or x and y read once and the output
    written once over 3.35 TB/s (H100 SXM HBM3), whichever is longer."""
    instr = CHAIN * INSTR_PER_ROUND * SUB * LANE
    t_ops = instr / (RESULTS_PER_CLOCK[dtype] * n_sm * clock_mhz * 1e6) * 1e3
    size = torch.empty((), dtype=dtype).element_size()
    t_bytes = 3 * SUB * LANE * size / 3.35e12 * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _event_seconds(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def bench(dtype, iters: int, device) -> dict:
    """`iters` launches, each on the previous one's output (two buffers in
    turn), timed with CUDA events after a warm-up run.  The TPU probe runs
    its loop inside one jitted dispatch, with no host between calls; here
    the same launches are captured in a CUDA graph and its replay is what
    is timed.  The time of the launches issued one by one from the host is
    returned beside it (`direct_ms`)."""
    x, y = probe_inputs(dtype, device)
    bufs = (torch.empty_like(x), torch.empty_like(x))

    def loop():
        src = x
        for i in range(iters):
            src = probe(src, y, out=bufs[i % 2])

    def replay():    # the graph's launches count when it runs them
        graph.replay()
        LAUNCHES[_NAMES[dtype]] += iters

    loop()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loop()
    replay()
    seconds = _event_seconds(replay)
    direct = _event_seconds(loop)
    ms = seconds * 1e3 / iters
    rate = iters * ops_per_call() / seconds
    name = str(dtype).removeprefix("torch.")
    print(f"{name:9s} {ms:8.3f} ms/call {rate / 1e12:6.2f} Top/s", flush=True)
    return {"ms": ms, "ops_per_s": rate, "direct_ms": direct * 1e3 / iters}


def main(iters: int = 50) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the probe times the card's kernels: no CUDA device")
    dev = torch.device("cuda")
    res = {dt: bench(dt, iters, dev) for dt in (torch.float32, torch.bfloat16)}
    ratio = res[torch.bfloat16]["ops_per_s"] / res[torch.float32]["ops_per_s"]
    print(f"bf16 / fp32 throughput ratio: {ratio:.2f}x", flush=True)
    clock = sm_clock_mhz()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for dt, r in res.items():
        r["bound_ms"], r["bound_by"] = bound_ms(dt, clock, n_sm)
        print(f"{str(dt).removeprefix('torch.'):9s} bound {r['bound_ms']:8.4f}"
              f" ms/call ({r['bound_by']}; {n_sm} SMs at {clock:.0f} MHz)",
              flush=True)
    return {"fp32": res[torch.float32], "bf16": res[torch.bfloat16],
            "ratio": ratio, "sm_clock_mhz": clock, "sms": n_sm}


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 50)
