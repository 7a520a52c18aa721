"""Export of the deploy-mode forward (counterpart of fastdet/export/): a
`torch.export` program with the deploy bake and the weights inside, saved
as a `.pt2` archive."""

from fastdet_torch.export.torch_export import (export_detector,
                                               export_graph_text,
                                               export_quantized,
                                               load_exported)

__all__ = ["export_detector", "export_graph_text", "export_quantized",
           "load_exported"]
