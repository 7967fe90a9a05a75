"""Run a train CLI module's cli() as `python -m <module> <overrides>` runs
it, with the train split's random draws seeded by the sample index:

    python -m torch_seeded_cli garmentnets_tpu_torch.harness.train_pointnet2 \\
        key=value ...

The datamodule draws the train samples' points, views and rotations from
fresh entropy every epoch (as the reference does), so two training runs
never read the same batches; tests/test_torch_torchrun.py compares two
launches of one CLI by their losses, so both read the train split as the
val split is read (static_epoch_seed). The patch is made when this module
is imported: the ranks that a CLI spawns itself (the spawn start method
imports the parent's main module in each child) make it too, and so does
each rank that torchrun starts with this module.
"""
import importlib
import sys

from garmentnets_tpu_torch.data import dataset

_prepare_data = dataset.ConvImplicitWNFDataModule.prepare_data


def _seeded_prepare_data(self):
    _prepare_data(self)
    self.train_dataset.static_epoch_seed = True


dataset.ConvImplicitWNFDataModule.prepare_data = _seeded_prepare_data

if __name__ == "__main__":
    module = sys.argv[1]
    sys.argv = [module] + sys.argv[2:]
    importlib.import_module(module).cli()
