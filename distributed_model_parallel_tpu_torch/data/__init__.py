"""Data of the port: the dataset registry (synthetic and CIFAR-10) and
the loader — batch order on the host, augmentation and normalization on
the device."""
