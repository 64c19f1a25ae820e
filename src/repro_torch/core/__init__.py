"""WiSparse projection dispatch and sparsity-parameter trees."""
