"""Host-side loops of the port: batched greedy evaluation (``trial``)."""
