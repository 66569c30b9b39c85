"""Selection engines: pair-block scheduling, the screened engine (single
device and tile-sharded), the dense engines (single device and mesh), the
ring engine, the multi-host tile slices and the engine dispatcher."""
