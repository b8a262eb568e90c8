"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name()`` gives. NVIDIA's H100 data sheet, SXM part,
dense rates without sparsity, at the full 700 W power limit."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops_per_s": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def peaks(card: str):
    """The card's peaks, or None for a card the table lacks (then no
    share of a peak is reported)."""
    return PEAKS.get(card)
