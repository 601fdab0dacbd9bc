"""Model zoo of the port: AlexNet, VGG-16/11, GoogLeNet, ResNet-50,
Cifar10 and the transformer LM (``registry.MODELS`` names them)."""
