from superdiff_torch.training.state import TrainState, create_train_state
from superdiff_torch.training.steps import make_eval_step, make_train_step

__all__ = ["TrainState", "create_train_state", "make_train_step",
           "make_eval_step"]
