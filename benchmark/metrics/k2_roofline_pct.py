"""K2's share of its roofline: the slot force kernel (`slot_kernels`,
`csrc/slot_kernels.cu`, `staged_kernel<DIM, T, true>`)."""

from benchmark.metrics import _roofline as rl


def read(obs):
    return rl.kernel_roofline_pct(
        obs, rl.K2,
        lambda d, fp: rl.force_ops(d, fp["near"], fp["particles"]),
        lambda d, fp: rl.force_bytes(d, fp["particles"]))
