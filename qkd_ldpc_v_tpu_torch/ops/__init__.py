"""Device operations: channel, the generic torch decoder, plain QC decoders
and the fused QC and generic kernels."""
