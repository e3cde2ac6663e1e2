"""``b2_stem_roofline.serve``, read in the bf16 serving cell at bs=128."""
from portbench.core import reader

read = reader("b2_stem_roofline.serve")
