"""K1's share of its roofline: the slot density kernel (`slot_kernels`,
`csrc/slot_kernels.cu`, `staged_kernel<DIM, T, false>`)."""

from benchmark.metrics import _roofline as rl


def read(obs):
    return rl.kernel_roofline_pct(
        obs, rl.K1, lambda d, fp: rl.density_ops(d, fp["near"]),
        lambda d, fp: rl.density_bytes(d, fp["particles"]))
