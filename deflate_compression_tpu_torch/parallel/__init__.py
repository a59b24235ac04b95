"""Data-parallel encode over torch.distributed (`dist.py`), its launcher
(`launcher.py`) and checkpoint/resume of long file encodes
(`checkpoint.py`)."""
