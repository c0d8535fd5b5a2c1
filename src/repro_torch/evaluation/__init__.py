"""The paper's evaluation (Figs. 6-10) on the port: the programs of the JAX
package's ``benchmarks/`` as modules of ``repro_torch``, run through
``repro_torch.core``'s entry points.

  common          timing (synchronised wall clocks, CUDA events on a card),
                  the three-column region and its CSV rows
  xsbench         Fig. 8a: macroscopic cross-section lookups, event and
                  history
  rsbench         Fig. 8b: multipole cross sections, event and history
  interleaved     Fig. 9a: array-of-struct against struct-of-array
  hypterm         Fig. 9b: the 8th-order flux stencil, three directions
  amgmk_pagerank  Fig. 9c: a Jacobi sweep and a page-rank step
  spec            Fig. 10: botsalgn, botsspar and smithwa
  allocator       Fig. 6: the heaps' grid, find_obj and sharded contrasts
  rpc             Fig. 7: the RPC round trip and the batched transports
  run             ``python -m repro_torch.evaluation.run``

Every region has JAX's three columns: ``serial`` (the single-team loop,
``serial_for``), ``gpu_first`` (the expanded loop, ``parallel_for``) and
``manual`` (the hand-vectorised port).  On a card the serial column may
run a prefix of the loop; its time is then scaled to the whole loop.
Data are drawn from a CPU ``torch.Generator`` seeded by the caller
(``jax.random`` cannot be reproduced without JAX) and moved to the
device, so every device gets the same inputs.
"""
