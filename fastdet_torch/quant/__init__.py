"""Post-training int8 quantization (counterpart of fastdet/quant/):
per-output-channel symmetric int8 weights, calibrated per-tensor
symmetric int8 activations, and exact integer contractions on the card
(f32 or cuBLASLt int8 MACs), over the folded eval graph of either model
family.  `save_quantized` writes, and `load_quantized` reads, the JAX
package's `.npz` artifact."""

from fastdet_torch.quant.ptq import (build_int8_forward, calibrate,
                                     fold_model, forward_folded,
                                     forward_folded_af, forward_from,
                                     infer_family, load_quantized,
                                     quantize_weights, save_quantized)

__all__ = ["build_int8_forward", "calibrate", "fold_model",
           "forward_folded", "forward_folded_af", "forward_from",
           "infer_family", "load_quantized", "quantize_weights",
           "save_quantized"]
