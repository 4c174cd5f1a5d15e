"""LCD core: the packing contract and the §4 LUT layer (lut.py), the
ClusteredTensor container and `compress_model` (api.py), the compression
pipeline under it (clustering.py, hessian.py, smoothing.py, distill.py) and
random-but-valid clustered parameter trees (clustered_params.py)."""
