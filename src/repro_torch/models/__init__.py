"""Models: PointNet2 with PC2IM preprocessing (pointnet2.py) on the nn.py layers."""
