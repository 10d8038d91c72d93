"""Device operations: channel, plain QC decoders and the fused QC kernel."""
