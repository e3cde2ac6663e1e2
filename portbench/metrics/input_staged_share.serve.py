"""Share of the input's bytes that reached the card staged in the program's
pinned host memory, in percent: the program's count ``staged_bytes`` over
``input_bytes`` (the bytes of the arrays the caller handed
``predict_batched``), summed over the input-copy spans
(``ssdx_torch.api.input_copy``) of every traced batch.  A program that
counts neither gives ``None``."""
from portbench.spans import count_share


def read(ctx):
    return count_share(ctx, "ssdx_torch.api.input_copy", "staged_bytes", "input_bytes")
