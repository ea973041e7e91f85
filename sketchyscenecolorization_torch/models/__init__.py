from . import deeplab, fg_gan, gan_layers, inception_v4, rmi
