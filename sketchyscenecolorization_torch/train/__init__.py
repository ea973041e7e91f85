"""Training of the port: matching, the FG GAN and the BG GAN, with their
losses, schedules, optimizer arithmetic, NaN watchdog and harnesses, and
the matching evaluation (``eval_matching``)."""
from .losses import (
    acgan_focal_loss, bg_discrim_loss, bg_gan_losses, dragan_losses,
    fc_weight_decay_loss, l2_regularization_loss, masked_l1_loss,
    region_softmax_xent, sigmoid_xent_with_logits, smooth_l1,
    sparse_softmax_xent, weighted_logistic_loss, wgan_gp_losses,
    wgan_sn_losses,
)
from .schedules import fg_gan_lr_decay, tf1_polynomial_decay
from .matching import (MatchingTrainState, create_matching_state,
                       make_matching_train_step, matching_loss_fn,
                       trainable_names)
from .fg_gan import (FGGanTrainState, create_fg_gan_state, fg_gan_draws,
                     make_fg_gan_train_step)
from .bg_gan import (BGGanTrainState, create_bg_gan_state,
                     make_bg_gan_train_step)
from .watchdog import NaNWatchdog, run_with_nan_restart
from .harness import (eval_matching, train_bg_gan, train_fg_gan,
                      train_matching)
