"""Faults planted under the timed path, each a picklable function that
breaks the program in the process that calls it. Each must make a run come
out not correct."""


def _wrap_growers(make):
    import repro_torch.core.booster as booster_mod
    import repro_torch.distributed.gbdt_shard as shard_mod

    booster_mod.grow_tree = make(booster_mod.grow_tree, bins_at=0)
    shard_mod._grow_tree_sharded = make(shard_mod._grow_tree_sharded, bins_at=1)


def state_unchanged() -> None:
    """Every round returns the first tree ever grown: the model's state
    stops moving after one step."""
    def make(inner, bins_at):
        first = []

        def grow(*args, **kwargs):
            res = inner(*args, **kwargs)
            if not first:
                first.append(res)
            return first[0] if len(first[0][1]) == len(res[1]) else res
        return grow
    _wrap_growers(make)


def half_batch() -> None:
    """Half the rows of every step's batch (all rows in core, the sampled
    rows out of core, a rank's rows when sharded) are left out: the step's
    draw keeps only the first half, so its statistics are the mean over the
    rest."""
    import repro_torch.core.booster as booster_mod
    import repro_torch.core.sampling as sampling_mod

    inner = sampling_mod.sample

    def sample(*args, **kwargs):
        keep, w = inner(*args, **kwargs)
        keep = keep.clone()
        kept = keep.nonzero().squeeze(1)
        keep[kept[kept.shape[0] // 2:]] = False
        return keep, w

    sampling_mod.sample = sample
    booster_mod.sample = sample


def draw_altered() -> None:
    """Every out-of-core draw keeps as many rows as it drew, but not the
    rows it drew: those with the smallest gradients, where a sound draw
    favours the largest."""
    import repro_torch.core.booster as booster_mod
    import repro_torch.core.sampling as sampling_mod

    inner = sampling_mod.sample

    def sample(generator, g, h, *args, **kwargs):
        keep, w = inner(generator, g, h, *args, **kwargs)
        altered = keep.clone().zero_()
        altered[g.abs().argsort()[: int(keep.sum())]] = True
        return altered, w

    sampling_mod.sample = sample
    booster_mod.sample = sample


def answer_altered() -> None:
    """One leaf value of every tree moves by 5% where it is produced."""
    def make(inner, bins_at):
        def grow(*args, **kwargs):
            res = inner(*args, **kwargs)
            tree = res[0]
            leaf = tree.leaf_value.clone()
            i = int(res[1][0])
            leaf[i] += 0.05 * abs(float(leaf[i])) + 1e-3
            new = (tree._replace(leaf_value=leaf), res[1])
            return type(res)(*new) if hasattr(res, "_fields") else new
        return grow
    _wrap_growers(make)


def exchange_left_out() -> None:
    """The histogram all-reduce is skipped: each rank splits on its own
    rows' histograms (the node totals are still summed)."""
    import repro_torch.distributed.gbdt_shard as shard_mod

    inner = shard_mod.Mesh.all_reduce

    def all_reduce(self, t, axes):
        return t if t.dim() >= 3 else inner(self, t, axes)

    shard_mod.Mesh.all_reduce = all_reduce
