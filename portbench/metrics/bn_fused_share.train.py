"""Share of the train step's BatchNorm + ReLU layers that ran on the BN +
ReLU kernels, in percent: the program's count ``bn_fused`` over
``bn_layers`` (the train-mode BN layers outside the stem kernel), summed
over the train-step spans (``ssdx_torch.train.step``) of every traced step.
A program that counts neither gives ``None``."""
from portbench.spans import count_share


def read(ctx):
    return count_share(ctx, "ssdx_torch.train.step", "bn_fused", "bn_layers")
