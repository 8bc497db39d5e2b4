"""The MST system's core on PyTorch: graphs, oracles, partitioners, runtime
and the single-device Borůvka engine (entry: :mod:`.mst_api`)."""
