"""Data of the port: the dataset registry (synthetic, CIFAR-10, the
ImageFolder and CUB-200 trees, decoded eagerly or per batch), the loader
— batch order on the host, the native row gather, the host and device
prefetch stages, the resize, augmentation and normalization on the
device — and ``native``, the C++ row gather built at first use."""
