"""launches_per_step.train_host: ``launches_per_step.train``'s reading (see its
file) in a host-bound training cell, where the host's speed spreads the
cell's time too widely for a bound and the time itself is read per layer."""

from gsbench.harness import load_module

read = load_module("metrics", "launches_per_step.train").read
