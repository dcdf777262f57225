"""A cell's configuration and traffic cut to a size the CPU runs in
seconds: the same code paths, fewer pixels, rays, slots and frames."""

import copy

from port_bench import manifest as mf


def tiny_cell(workload: str, input: str = None, update_mode: str = None):
    """-> (config, workload) of ``workload`` at the tiny size; ``input`` and
    ``update_mode`` replace the traffic's frame input and the map's update
    mode (the traffic and configuration a data file alone can ask for)."""
    wl = mf.load_workload(workload)
    cfg = copy.deepcopy(mf.load_config(wl["config"]))
    cfg["scene"].update(width=32, height=24, fx=28.0, fy=28.0, lap_frames=40)
    cfg["map"].update(num_kf_slots=20, num_train_fields=4, num_rays_per_field=16, pixel_block_size=256,
                      num_iterations_per_frame=2)
    if update_mode is not None:
        cfg["map"]["update_mode"] = update_mode
    wl = dict(wl, warmup_frames=6, train_frames=10, check_images=1, check_blocks=1)
    if input is not None:
        wl["input"] = input
    return cfg, wl
