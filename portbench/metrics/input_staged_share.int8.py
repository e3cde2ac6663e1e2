"""``input_staged_share.serve``, read in the int8 serving cell, whose throughput is a
metric of its own (``serve_images_per_s.int8``)."""
from portbench.core import reader

read = reader("input_staged_share.serve")
