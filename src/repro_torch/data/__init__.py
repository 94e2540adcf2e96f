from repro_torch.data.pipeline import (BatchIterator, ClientDataPool,
                                       token_batches)
from repro_torch.data.synthetic import (ClassificationData, make_cifar_like,
                                        make_mnist_like, make_token_stream)
