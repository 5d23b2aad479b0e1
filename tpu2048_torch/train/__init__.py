"""Host-side loops of the port: batched greedy evaluation (``trial``)
and the training loop (``Trainer``)."""

import torch


def card_device(device, who: str) -> torch.device:
    """``device``, or the CUDA card when it is None.  Without a card
    the default raises: the CPU runs only when the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA card found; pass device=\"cpu\" "
                           "to run on the CPU")
    return torch.device("cuda")
