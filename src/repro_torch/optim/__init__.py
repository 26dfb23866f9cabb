from repro_torch.optim.optimizers import (OptState, adam, make_optimizer,
                                          momentum, sgd)
