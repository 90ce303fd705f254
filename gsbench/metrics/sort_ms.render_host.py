"""sort_ms.render_host: ``sort_ms.render``'s reading (see its file) in a host-
bound rendering cell, where the host's speed spreads the cell's time too
widely for a bound and the time itself is read per layer."""

from gsbench.harness import load_module

read = load_module("metrics", "sort_ms.render").read
