from avatarcraft_tpu_torch.data.smpl_dataset import SMPLMultiviewDataset

__all__ = ["SMPLMultiviewDataset"]
