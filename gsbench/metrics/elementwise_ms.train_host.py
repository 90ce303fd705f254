"""elementwise_ms.train_host: ``elementwise_ms.train``'s reading (see its file)
in a host-bound training cell, where the host's speed spreads the cell's
time too widely for a bound and the time itself is read per layer."""

from gsbench.harness import load_module

read = load_module("metrics", "elementwise_ms.train").read
