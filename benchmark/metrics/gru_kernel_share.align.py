"""Bi-GRU layers the align head ran through the recurrence kernel over all
its bi-GRU layers, %, from the program's counters over the process
(head.gru_kernel_layers, head.gru_cudnn_layers)."""
from benchmark.spans import counts


def read(run):
    found = counts()
    if not found:
        return None
    kernel = found.get("head.gru_kernel_layers", 0)
    total = kernel + found.get("head.gru_cudnn_layers", 0)
    if not total:
        return None
    return 100.0 * kernel / total
