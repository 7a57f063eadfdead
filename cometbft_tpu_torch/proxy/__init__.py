from cometbft_tpu_torch.proxy.multi_app_conn import (
    AppConns,
    ClientCreator,
    local_client_creator,
    remote_client_creator,
    new_multi_app_conn,
)
