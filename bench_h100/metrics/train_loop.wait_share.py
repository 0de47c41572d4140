"""Share of the window's train_epoch time the main thread waited for staged batches (the program's last_epoch_trace wait_s over total_s, summed over the epochs)."""

from bench_h100.metrics import common


def read(trace):
    return common.wait_share(trace)
