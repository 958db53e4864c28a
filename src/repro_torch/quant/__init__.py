"""The quant plane of the port: versioned product-quantization codebooks."""
