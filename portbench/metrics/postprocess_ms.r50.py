"""``postprocess_ms.serve``, read in the ResNet-50 serving cell."""
from portbench.core import reader

read = reader("postprocess_ms.serve")
