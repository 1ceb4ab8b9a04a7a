"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (csrc/ holds the sources; build.py compiles them at first use)."""


def launch_counters() -> dict:
    """Every kernel wrapper, by the name ``chip_smoke.py``'s kernels line
    gives it: each adds one to its ``launches`` where it launches its
    kernel, and nowhere else."""
    from . import (block_cols, collision_force, flash_attention, pair_cols,
                   pairlist, secretion)
    return {"k1_collision_force": collision_force.collision_force,
            "k1_column_map": block_cols.column_map,
            "k2_flash_attention": flash_attention.flash_attention,
            "pairlist_build": pairlist.build_list,
            "k1_pair_cols": pair_cols.column_map_from_pairs,
            "secretion": secretion.add}
