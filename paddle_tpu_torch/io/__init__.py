"""The data pipeline of the port (``paddle_tpu/io``): datasets, samplers,
the ``DataLoader`` with its thread, process and native (C++) feeds, and
sequence packing."""
from . import packing  # noqa: F401
from .dataloader import (DataLoader, WorkerInfo, default_collate_fn,  # noqa
                         get_worker_info)
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,  # noqa
                      IterableDataset, Subset, TensorDataset, random_split)
from .packing import (PackingCollator, pack_documents,  # noqa
                      packed_train_batch, packing_efficiency)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,  # noqa
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)
