from .arrow_dataset import ArrowDataset  # noqa: F401
from .collators import MLMCollator  # noqa: F401
from .datamodule import DataModule, MTDataModule, MultiMTDataModule  # noqa: F401
from .datasets import dataset_class  # noqa: F401
from .loader import ConcatDataset, DataLoader  # noqa: F401
from .masking_generator import MaskingGenerator  # noqa: F401
from .sampler import ShardedBatchSampler  # noqa: F401
from .text import build_tokenizer, WordPieceTokenizer, write_tiny_vocab  # noqa: F401
from . import transforms  # noqa: F401
