"""Meshes over ``torch.distributed`` (:mod:`.mesh`) and shape-only
stand-ins for every model input (:mod:`.specs`)."""
