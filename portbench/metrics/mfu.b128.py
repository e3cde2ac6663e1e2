"""``mfu.serve``, read in the bf16 serving cell at bs=128."""
from portbench.core import reader

read = reader("mfu.serve")
