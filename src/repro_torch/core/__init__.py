"""LCD core, serving half: the packing contract (lut.py), the ClusteredTensor
container (api.py) and random-but-valid clustered parameter trees
(clustered_params.py)."""
