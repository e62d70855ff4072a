"""Distributed-training pieces the port has so far: mixed precision
(port of ``repro.distributed``)."""
