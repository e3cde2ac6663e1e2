"""Share of the traced train steps that the program replayed from a CUDA
graph, in percent: the program's count ``replayed`` over ``steps``, summed
over the train-step spans (``ssdx_torch.train.step``) of every traced step.
A program that counts neither gives ``None``."""
from portbench.spans import count_share


def read(ctx):
    return count_share(ctx, "ssdx_torch.train.step", "replayed", "steps")
