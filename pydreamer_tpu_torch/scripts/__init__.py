"""The port's run tools, each run as ``python -m pydreamer_tpu_torch.scripts.<tool>``.

Counterparts of the JAX side's ``scripts/``:

* ``export_metrics``, ``plot_curves``, ``make_gif``: thin CLIs over
  ``analysis.py`` (a run's metrics to CSV, learning curves to PNG, a dream
  dump to GIF);
* ``canaries``: the learning canaries of ``tests/test_learning.py`` written
  once, for the tests, the diagnose tools and ``chip_smoke.py``;
* ``diagnose_gridworld_pixels``, ``diagnose_continuous``: in-process learning
  loops that print one CSV row per window;
* ``demo_gridworld.sh``, ``demo_dmc.sh``: resumable live runs of the port's
  launcher, segment by segment.
"""
