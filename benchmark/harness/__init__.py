"""The benchmark harness of splashsurf_tpu_torch: one run of one cell
(``runner``), the cycle's frames (``scenes``), its statistics (``stats``),
its trace (``trace``), its work counts (``work``) and its roofline
arithmetic (``roofline``). Configurations, traffic mixes and limits are
data files, and scenes, motions, placements, entry points and metrics
small modules of their own, all found by name (``files``)."""
