"""The models the port trains, by short name.

Counterpart of ``theanompi_tpu/models/registry.py`` for the models the port
has: the dotted modelfile, the modelclass, and the synthetic-data config
that makes each runnable with no data set up (the reference launcher's
import-by-string contract).  ``MoETransformerLM`` is not ported.
"""

MODELS = {
    "alexnet": ("theanompi_tpu_torch.models.alex_net", "AlexNet",
                {"synthetic_batches": 4}),
    "googlenet": ("theanompi_tpu_torch.models.googlenet", "GoogLeNet",
                  {"synthetic_batches": 4}),
    "vgg16": ("theanompi_tpu_torch.models.vggnet_16", "VGGNet_16",
              {"synthetic_batches": 4}),
    "resnet50": ("theanompi_tpu_torch.models.resnet50", "ResNet50",
                 {"synthetic_batches": 4}),
    "transformer_lm": ("theanompi_tpu_torch.models.transformer_lm",
                       "TransformerLM",
                       {"synthetic_train": 2048, "sample_kind": "sequences"}),
    "cifar10": ("theanompi_tpu_torch.models.cifar10", "Cifar10_model",
                {"synthetic_train": 8192}),
}
