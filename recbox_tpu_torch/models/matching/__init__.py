from recbox_tpu_torch.models.matching.two_tower import DSSM, MF, YoutubeDNN

__all__ = ["MF", "DSSM", "YoutubeDNN"]
