"""The reference's examples as entry points of the port (counterparts of
``examples/*.py``), each run as ``python -m repro_torch.examples.<name>``
on the CUDA card, or on the CPU with ``--device cpu``:

  quickstart       cell proliferation under collision forces (K1)
  oncology         tumor growth with deaths on the capacity ladder, then a
                   checkpoint and a bit-exact resume (K1)
  neuroscience     neurite growth with static regions (K1)
  cell_clustering  secretion and chemotaxis on a diffusion grid; with
                   ``--pairlist`` contact forces from a Verlet pair list
                   (secretion, the pair-list build, its column map, K1)
  ensemble_sweep   an SIR (β, 1/γ) sweep served over ensemble lanes
  serve_lm         continuous batching of a small LM over the paged KV pool

Each keeps its reference's ``make_config()`` (or set-up function),
``behaviors()``, environment knobs (``EXAMPLE_N``, ``EXAMPLE_EPOCHS``,
``EXAMPLE_LANES``, ``EXAMPLE_POINTS``, ``EXAMPLE_STEPS``), printed lines
and closing assertions. Where a reference config leaves ``force_impl`` at
its default, the port's default applies: K1 on the uniform grid.
"""
