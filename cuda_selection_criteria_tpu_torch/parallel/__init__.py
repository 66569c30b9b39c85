"""Selection engines: pair-block scheduling, the screened single-device
engine and the engine dispatcher."""
