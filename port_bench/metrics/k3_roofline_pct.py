"""K3, the replay kernel (replay_persistent): the least time the card could take for the profiled launches' work,
counted by the benchmark's reference over the same inputs and priced at
the published peaks (harness/roofline.py), over the kernel's device
time, in %."""

from harness.shares import roofline_share


def read(ctx):
    return roofline_share(ctx, "k3")
