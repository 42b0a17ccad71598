"""Models of the port: the dense and ssm families of the reference's
model zoo, in PyTorch, with attention through K4 and the SSD scan
through K5 (start at :mod:`repro_torch.models.model`)."""
