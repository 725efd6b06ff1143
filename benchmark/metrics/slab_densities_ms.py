"""slab_densities_ms (ms, program span): the slab route's densities stage,
``splashsurf_tpu_torch.ops.slab_sweep.LAST_RUN["stage_s"]["densities"]``
(its stage clock synchronises the device at each stage boundary), read
after every frame of the window, mean per frame that took the route. Each
slab run puts a new stage dict there, so a frame that took another route
adds nothing."""


def after_frame(run, k, rec):
    from splashsurf_tpu_torch.ops import slab_sweep

    stages = slab_sweep.LAST_RUN.get("stage_s")
    if stages is None or stages is run.state.get("slab_stages_seen"):
        return
    run.state["slab_stages_seen"] = stages
    if "densities" in stages:
        run.state.setdefault("slab_densities", []).append(float(stages["densities"]))


def read(run):
    xs = run.state.get("slab_densities")
    return 1e3 * sum(xs) / len(xs) if xs else None
