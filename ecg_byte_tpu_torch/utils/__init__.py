"""Host utilities: file pairing, metrics, the loss plot."""
