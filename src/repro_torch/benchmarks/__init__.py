"""Benchmarks of the port, ported from the reference's ``benchmarks/``
package into this one, so that they import nothing of ``repro``:
:mod:`.serve_traffic`, the closed-loop serving load."""
