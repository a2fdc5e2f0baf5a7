from gennbv_tpu_torch.env.drone_robot import DroneRobot, DroneRobotConfig  # noqa: F401
from gennbv_tpu_torch.env.recon_env import EnvState, ReconEnv, StepOutput  # noqa: F401
from gennbv_tpu_torch.env.scene import SceneSet, make_scenes  # noqa: F401
