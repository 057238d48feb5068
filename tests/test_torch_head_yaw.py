"""Port vs reference: the tiny detector with the yaw head
(``bbox_mode='yaw7d'``), predict and one train step; the tests and their
gates are ``torch_head_detector.py``'s."""

from torch_head_detector import (run, test_predict,  # noqa: F401
                                 test_train_step_gradients,
                                 test_train_step_integer_outputs_identical,
                                 test_train_step_losses)

MODE = 'yaw7d'
