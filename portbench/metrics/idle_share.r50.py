"""``idle_share.serve``, read in the ResNet-50 serving cell."""
from portbench.core import reader

read = reader("idle_share.serve")
