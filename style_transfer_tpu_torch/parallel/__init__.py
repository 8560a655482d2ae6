"""Device mesh and spatial sharding: VGG activations split along H over an
ordered list of devices, driven from one process."""
